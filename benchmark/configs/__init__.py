"""Scene configurations: `<name>.json` holds the sizes as run, `<name>.py`
the frozen scene maker that builds them through a scene API (the
program's `scene.model`, or the plain reference's copy of it)."""
