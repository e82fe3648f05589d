"""Host seconds of the program's compile_scene in set-up (synchronised)."""


def read(data):
    return data.compile_s or None
