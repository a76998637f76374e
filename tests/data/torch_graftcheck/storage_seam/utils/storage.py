import os


def write_bytes(path, data):
    with open(path, "wb") as f:
        f.write(data)
