def used():
    return 1


def dead_helper():
    return 2


class C:
    def dead_method(self):
        pass

    def live_method(self):
        return used()


entry = used


def caller(c: C):
    return c.live_method()
