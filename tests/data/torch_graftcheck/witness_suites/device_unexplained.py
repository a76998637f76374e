"""Seeded device fault: a function of a port module reads a tensor back
with ``.item()`` outside every explained site."""

import torch

SEEDED = "def leak(t):\n    return t.sum().item()\n"


def test_unexplained_item():
    ns = {"__name__": "tfidf_tpu_torch.engine.seeded"}
    exec(SEEDED, ns)
    assert ns["leak"](torch.ones(3)) == 3.0
