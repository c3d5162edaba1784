"""Fig. 3 analogue, taskset pinning: the node-contiguous rank order against
a naive one on 16 x 16 GPUs in NVLink domains of 8 (``core/affinity.py``),
scored as ring-step cost and the wire time it implies for the all-reduce
over 'model' of the sweep's ``inner`` cell at the 16 x 16 split (the bytes
``core/op_cost.py`` counts for it, ``core.sweep.lower_cell``).

Counterpart of the root ``benchmarks/pinning.py``, which prices a TPU dry
run's collective bytes for glm4-9b's training step; the port prices the
sweep's cell until it counts glm4's step (ROADMAP.md, Queue 1).

CSV: name,us_per_call,derived  (us_per_call = derived wire time of the
cell's 'model' all-reduce at ``H100.ici_bw`` times the placement's
``collective_slowdown``; derived, no device runs)
"""
from repro_torch.core.affinity import (collective_slowdown, naive_placement,
                                       pinned_placement)
from repro_torch.core.roofline import H100
from repro_torch.core.sweep import SweepCell, lower_cell

CELL = SweepCell(16, 16, "inner", "cache")


def rows(device=None, small=False):
    """One row per placement.  ``device`` and ``small`` are the harness's
    arguments; the rows are derived and use neither."""
    coll = lower_cell(CELL)["collective_bytes_per_device"]
    out = []
    for p in (pinned_placement(), naive_placement()):
        mult = collective_slowdown(p, "model")
        wire_s = coll / H100.ici_bw * mult
        out.append((f"pinning/{p.name}", wire_s * 1e6,
                    f"model-ring={p.axis_ring_cost['model']:.2f}"
                    f";model-slowest={mult:.2f}"
                    f";data-ring={p.axis_ring_cost['data']:.2f}"
                    f";data-slowest={collective_slowdown(p, 'data'):.2f}"
                    f";slowdown={mult:.2f}x;bytes={coll:.0f}"))
    return out


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
