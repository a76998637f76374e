import threading


def park(ev):
    ev.wait()


def bounded(ev):
    ev.wait(1.0)
