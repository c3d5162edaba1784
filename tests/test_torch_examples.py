"""The port's examples (``python -m repro_torch.examples.<name>``) run to
their end on the CPU with ``--device cpu``, each keeping its own checks:
training lowers the loss and decodes, the batch drains through an
overcommitted pool, streams end with a clean pool after a cancel, the
sweep measures both engines, and the 100M driver checkpoints and resumes.
Without ``--device`` they run on the card and never fall back."""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)

from repro_torch.examples import (quickstart, serve_batch,  # noqa: E402
                                  serve_stream, sweep_demo, train_100m)


def test_quickstart_trains_then_decodes():
    history, out = quickstart.main(["--device", "cpu", "--steps", "6"])
    assert len(history) == 6 and history[-1]["loss"] < history[0]["loss"]
    assert len(out) == 12 and all(0 <= t < 512 for t in out)


def test_serve_batch_drains_an_overcommitted_pool():
    results = serve_batch.main(["--device", "cpu"])
    assert len(results) == 10 and all(len(v) == 8 for v in results.values())


def test_serve_stream_cancels_and_leaves_the_pool_clean():
    assert serve_stream.main(["--device", "cpu"]) == 0


def test_sweep_demo_measures_both_engines():
    rows = sweep_demo.main(["--device", "cpu"])
    assert [r["engine"] for r in rows] == ["cublas"] * 4 + ["kernel"] * 2
    assert [r["N"] for r in rows] == [1024, 704, 512, 384, 384, 256]
    assert all(r["gflops"] > 0 and r["device"] == "cpu" for r in rows)


def test_train_100m_checkpoints_and_resumes(tmp_path):
    args = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
            "--seq-len", "32", "--batch", "2", "--ckpt-dir", str(tmp_path)]
    first = train_100m.main(args + ["--steps", "3"])
    assert [h["step"] for h in first] == [0, 1, 2]
    again = train_100m.main(args + ["--steps", "5"])
    assert [h["step"] for h in again] == [3, 4]


@pytest.mark.parametrize("mod", [quickstart, serve_batch, serve_stream,
                                 sweep_demo, train_100m],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_run_on_the_card_unless_told(mod, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
