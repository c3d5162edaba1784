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

``test_model_split_matches_jax`` holds the 'model' split of the compute
(the FFN's columns and rows, the vocabulary, the experts, the query heads
under ``heads_tp``, Mamba's inner channels) at 'model' 2 and 4, one rank
run a mesh; in each rank the working copy of every split leaf is its
'model' slice and exactly the leaves of ``split`` are cut
(``_torch_train_ranks.assert_working_copies``):

- (1, 2): qwen2-1.5b smoke (tied head) with ``heads_tp``; glm4-9b smoke
  (untied head) with ``heads_tp`` and a ``loss_mask``; arctic smoke (8
  experts, top-2, a dense residual) in the dispatch and the dropless
  form; jamba smoke (Mamba, MoE and attention blocks);
- (2, 2): qwen2-1.5b with ``heads_tp``, and with ``use_flash`` as well
  (the flash kernel on a rank's rows and heads);
- (1, 4): qwen2-1.5b with ``heads_tp``, whose G = 2 query heads a KV
  group 'model' 4 does not divide: the heads stay whole, the FFN and the
  vocabulary split.

The saved residuals' sequence split (JAX's ``act_res_seq``,
``seq_shard_residuals``, on by default): every case at 'model' > 1 keeps
the residuals between remat'd blocks as the rank's rows of the sequence,
and the ranks assert that the boundary ran exactly where it should
(``_torch_train_ranks.assert_res_seq``).  At (1, 2) two more cases keep
them whole: the flag off, and a sequence of 31 positions, which 'model' 2
does not divide.  ``test_res_seq_backward_without_a_mesh`` runs the
(1, 2) step with its backward pass on a thread with no mesh installed, as
tests/test_torch_remat_mesh.py does: the recomputation's all-gather of
the rank rows reaches its group without the ambient mesh.
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


FFN = ("w_gate", "w_up", "w_down")
HEADS = ("wq", "bq", "wo")
EXPERTS = ("we_gate", "we_up", "we_down")
MAMBA = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A_log",
         "ssm_D", "out_proj")
QWEN_HEADS_TP = {"arch": "qwen2-1.5b", "heads_tp": True,
                 "split": FFN + ("tok_embed",) + HEADS}
ARCTIC = {"arch": "arctic-480b",
          "split": FFN + ("tok_embed", "out_head") + EXPERTS}
SPLIT_CASES = {
    (1, 2): {
        "qwen_heads_tp": QWEN_HEADS_TP,
        "untied_mask_heads_tp": {"arch": "glm4-9b", "heads_tp": True,
                                 "mask": True,
                                 "split": FFN + ("tok_embed", "out_head")
                                 + HEADS},
        "arctic_dispatch": ARCTIC,
        "arctic_dropless": {**ARCTIC, "moe_impl": "ragged"},
        "jamba": {"arch": "jamba-1.5-large-398b",
                  "split": FFN + ("tok_embed", "out_head") + EXPERTS + MAMBA},
        "res_seq_off": {**QWEN_HEADS_TP,
                        "cfg": {"seq_shard_residuals": False}},
        "res_seq_undivided": {**QWEN_HEADS_TP, "seq": 31},
    },
    (2, 2): {
        "qwen_heads_tp": QWEN_HEADS_TP,
        "flash_heads_tp": {**QWEN_HEADS_TP, "cfg": {"use_flash": True}},
    },
    (1, 4): {
        "qwen_heads_tp_undivided": {**QWEN_HEADS_TP,
                                    "split": FFN + ("tok_embed",)},
    },
}
_JAX = {}  # case name -> (case, batch, tree, loss, state): one JAX step each


def _jax_split_case(name: str, case: dict):
    if name not in _JAX:
        from repro.configs import get_config

        vocab = get_config(case["arch"], smoke=True).vocab_size
        batch = make_batch(vocab, seed=len(_JAX) + 11,
                           mask=case.get("mask", False))
        if "seq" in case:
            batch = {k: v[:, :case["seq"]] for k, v in batch.items()}
        jcase = {k: v for k, v in case.items()
                 if k not in ("mask", "heads_tp", "split", "seq")}
        _JAX[name] = (batch,) + jax_case(jcase, batch)
    return _JAX[name]


@pytest.mark.parametrize("shape", list(SPLIT_CASES),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_split_matches_jax(shape):
    pytest.importorskip("jax")
    named = SPLIT_CASES[shape]
    cases, batches, trees, want = [], [], {}, []
    for name, case in named.items():
        batch, tree, loss, state = _jax_split_case(name, case)
        trees[case["arch"]] = tree
        cases.append({k: v for k, v in case.items() if k != "mask"})
        batches.append(batch)
        want.append((loss, state))
    results = run_ranks("_torch_train_ranks:train_rank", shape[0] * shape[1],
                        (shape, cases, trees, batches), device="cpu")
    for r, got in enumerate(results):
        for name, (loss, state), (want_loss, want_state) in zip(
                named, got, want, strict=True):
            assert_like_jax(loss, state, want_loss, want_state,
                            f"{name} {shape} rank {r}")


def test_res_seq_backward_without_a_mesh():
    """qwen2-1.5b smoke with ``heads_tp`` at (1, 2), remat "full": the
    forward under the mesh, the backward pass on a thread that sees none
    (``_torch_train_ranks.remat_mesh_rank``), the residuals kept as the
    rank's rows; the loss and state against JAX's single-device step."""
    pytest.importorskip("jax")
    name = "qwen_heads_tp"
    batch, tree, loss, state = _jax_split_case(name, QWEN_HEADS_TP)
    case = {k: v for k, v in QWEN_HEADS_TP.items() if k != "split"}
    results = run_ranks("_torch_train_ranks:remat_mesh_rank", 2,
                        ((1, 2), [case], tree, batch), device="cpu")
    for r, [(got_loss, got, _)] in enumerate(results):
        assert_like_jax(got_loss, got, loss, state,
                        f"backward without a mesh, rank {r}")
