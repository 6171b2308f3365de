"""The port's examples (``examples/*_torch.py``) run in this process with
``--device cpu`` at small sizes and end ``OK`` on their JAX namesakes'
gates (recall and precision > 0.9, the HLL estimates within 0.1, no
banned 3-gram, a falling loss and a recovered failure); without a card
and without ``--device cpu`` each refuses to run rather than fall back.
"""
import os
import runpy

import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SMALL = {
    "quickstart_torch": ["--chars", "20000"],
    "count_distinct_torch": ["--chars", "100000"],
    "dedup_corpus_torch": ["--docs", "200"],
    "serve_lm_torch": ["--steps", "16"],
    "train_lm_torch": ["--steps", "8", "--batch", "2", "--seq", "64"],
}


def _main(name):
    return runpy.run_path(os.path.join(EXAMPLES, name + ".py"),
                          run_name=name)["main"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_ends_ok_on_the_cpu(name, capsys, tmp_path):
    argv = ["--device", "cpu"] + SMALL[name]
    if name == "train_lm_torch":
        argv += ["--ckpt-dir", str(tmp_path / "ckpt")]
    _main(name)(argv)
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1].startswith("OK")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_without_a_card_does_not_fall_back(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _main(name)(SMALL[name])
