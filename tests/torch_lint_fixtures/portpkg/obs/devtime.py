def register_program(name, kind="inner", site=None, launches=None):
    return name


def record_compile(name, signature, wall_s):
    return None
