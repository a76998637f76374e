"""The port's trace demo (``python -m tfidf_tpu_torch.tools.trace_demo``)
on the CPU: three port nodes in one process, ten uploads, an owning
worker's data plane killed; the rendered trace of the last search shows
the failed ``scatter.worker`` span and the ``scatter.slice`` failover that
kept every hit."""

import re

import pytest
import torch

from tfidf_tpu_torch.tools import trace_demo


def test_demo_shows_the_failover_and_returns_every_hit(capsys):
    assert trace_demo.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"search returned {trace_demo.UPLOADS} of {trace_demo.UPLOADS} " \
        "hits through a mid-request worker kill" in out, out
    lines = out.splitlines()
    failed = [ln for ln in lines if "scatter.worker" in ln and "error=" in ln]
    assert failed, out
    slices = [ln for ln in lines
              if "scatter.slice" in ln and "kind=failover" in ln]
    assert slices, out
    # the failover re-issued the dead worker's slice to a live worker,
    # which scored it
    dead = re.search(r"worker=(\S+)", failed[0]).group(1)
    alive = re.search(r"worker=(\S+)", slices[0]).group(1)
    assert dead != alive
    assert "worker.process_batch" in out


def test_demo_runs_on_the_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert trace_demo.main([]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
