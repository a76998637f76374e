import time


def f():
    deadline = time.time() + 5
    return deadline


def g():
    while time.time() < 9:
        pass


def h():
    return {"created_at": time.time()}


def ok():
    return time.monotonic() - 1
