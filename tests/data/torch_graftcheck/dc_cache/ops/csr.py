def next_capacity(n, minimum):
    c = minimum
    while c < n:
        c *= 2
    return c
