"""The port's sharded train step on a (2, 2) ("data", "model") mesh of
gloo ranks against JAX's single-device step, in the variants that change
what a shard must reduce over (tolerances and checks as in
tests/test_torch_train_sharded.py, one rank run for all cases):

- int8 moments: an int8 moment's row scale is the whole row's maximum
  (``w_gate``'s last axis is split over 'model'), so the gathered ``q`` and
  ``qscale`` are JAX's; compared dequantized;
- ``microbatches=2`` with a ``loss_mask``: microbatch i is the global rows
  [4 i, 4 i + 4), each split over 'data', and each microbatch's loss
  divides by its global mask sum;
- llama4-maverick smoke (MoE): the load-balance loss is E x sum(load x
  importance) over the global batch, not a mean of per-rank products;
- ``use_flash``: attention through the flash kernel on each rank's rows
  (JAX's runs it as its own tests do on the CPU).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from test_torch_train_sharded import assert_like_jax, jax_case, make_batch  # noqa: E402

CASES = {
    "int8_moments": {"arch": "qwen2-1.5b", "opt": {"state_dtype": "int8"}},
    "microbatches_mask": {"arch": "qwen2-1.5b", "microbatches": 2,
                          "mask": True},
    "llama4_moe": {"arch": "llama4-maverick-400b-a17b"},
    "use_flash": {"arch": "qwen2-1.5b", "cfg": {"use_flash": True}},
}


def test_sharded_step_variants_match_jax():
    pytest.importorskip("jax")
    from repro.configs import get_config

    cases, batches, trees, want = [], [], {}, []
    for i, case in enumerate(CASES.values()):
        vocab = get_config(case["arch"], smoke=True).vocab_size
        batch = make_batch(vocab, seed=i + 1, mask=case.get("mask", False))
        tree, loss, state = jax_case(case, batch)
        trees[case["arch"]] = tree
        case = {k: v for k, v in case.items() if k != "mask"}
        cases.append(case)
        batches.append(batch)
        want.append((loss, state))
    results = run_ranks("_torch_train_ranks:train_rank", 4,
                        ((2, 2), cases, trees, batches), device="cpu")
    for r, got in enumerate(results):
        for name, (loss, state), (want_loss, want_state) in zip(
                CASES, got, want, strict=True):
            assert_like_jax(loss, state, want_loss, want_state,
                            f"{name} rank {r}")
