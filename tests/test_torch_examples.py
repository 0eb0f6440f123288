"""The port's examples (examples/*_torch.py) run end to end on the CPU at
reduced sizes: quickstart's routes, recall and insert; rag_serve's answers
inside their filters, in one flush; train_lm's finite, falling losses and
its resume."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_routes_recall_and_insert(capsys):
    res = load("quickstart_torch.py").main(["--n", "2000", "--device",
                                            "cpu"])
    assert "routes:" in capsys.readouterr().out
    assert len(res["mechanisms"]) == 8
    assert set(res["mechanisms"]) <= {"pre", "in", "post", "scan"}
    assert len(set(res["mechanisms"])) >= 2
    assert np.mean(res["recalls"]) >= 0.9
    assert res["inserted"] == list(range(2000, 2016))
    assert res["insert_found"]


def test_rag_serve_answers_inside_filters():
    """The example asserts every match against the source arrays; here the
    flush, the answers and the generated tokens."""
    res = load("rag_serve_torch.py").main(["--docs", "800", "--device",
                                           "cpu"])
    assert res["flushed"] == 4 and res["batches"] == 1
    assert sum(len(a["matches"]) for a in res["answers"]) > 0
    for a in res["answers"]:
        assert len(a["generated"]) == 8
        assert all(0 <= t < 512 for t in a["generated"])


@pytest.mark.parametrize("name", ["hundred_m_config", "tiny_config"])
def test_train_lm_configs_equal_jax_example(name):
    """The port's configs are examples/train_lm.py's, field for field, with
    its parameter counts."""
    import dataclasses
    from repro.models import lm as JLM
    from repro_torch.models import lm
    want = getattr(load("train_lm.py"), name)()
    got = getattr(load("train_lm_torch.py"), name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert lm.param_count(got) == JLM.param_count(want)


def test_train_lm_losses_fall_and_resume(tmp_path):
    mod = load("train_lm_torch.py")
    args = ["--batch", "4", "--seq", "64", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "10", "--device", "cpu"]
    res = mod.main(["--steps", "30", *args])
    losses = res["losses"]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    more = mod.main(["--steps", "33", *args])
    assert more["start"] == 21 and len(more["losses"]) == 12
