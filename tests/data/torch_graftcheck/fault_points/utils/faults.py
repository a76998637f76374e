KNOWN_FAULT_POINTS: dict[str, str] = {
    "known.point": "covered",
    "ghost.point": "never fired anywhere",
}


def fault_point(name):
    pass
