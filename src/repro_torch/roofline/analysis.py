"""The three-term roofline of a dry-run cell, in seconds per step:

    compute    = FLOPs_per_rank / peak_FLOPs_card
    memory     = bytes_per_rank / HBM_bw_card
    collective = wire_bytes_per_rank / link_bw

The port's counterpart of ``repro.roofline.analysis``. ``model_flops``,
``roofline_report`` and ``format_row`` are the reference's arithmetic;
only the hardware differs. FLOPs and bytes come from the dry run's count
of the rank's local aten ops (``launch.dryrun``), and the collectives
from the functional collectives the DTensor program issues
(:func:`collective_record`), one record per op kind with the reference's
keys, ``{count, bytes, wire_bytes}``: bytes are the result's, and the
wire bytes those times the reference's ``_WIRE_FACTOR`` (2 for a ring
all-reduce, a reduce-scatter then an all-gather; 1 for the others).

``HW_H100`` is NVIDIA's data sheet for the H100 SXM5 80 GB at its 700 W
limit, not a measurement: 989 TFLOP/s dense bf16 (tensor cores), 3.35
TB/s HBM3, 80 GB, and 450 GB/s of NVLink 4 per direction (the sheet's
900 GB/s counts both). A production mesh of 256 or 512 ranks spans
nodes of 8 cards, and traffic between nodes runs over the network at a
fraction of the NVLink rate, so the collective term is a lower bound.
"""
from __future__ import annotations

from typing import Dict, Optional

HW_H100 = {
    "peak_flops": 989e12,       # dense bf16 FLOP/s per card
    "hbm_bw": 3.35e12,          # bytes/s per card
    "link_bw": 450e9,           # NVLink 4 bytes/s per direction
    "hbm_bytes": 80e9,          # HBM capacity per card
}

# the functional collectives a DTensor program issues -> the reference's
# HLO op names
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_record(out: Dict[str, Dict[str, float]], op: str,
                      result_bytes: int) -> None:
    """Count one collective ``op`` (an HLO name of ``_WIRE_FACTOR``) whose
    result holds ``result_bytes`` into ``out``."""
    rec = out.setdefault(op, {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
    rec["count"] += 1
    rec["bytes"] += result_bytes
    rec["wire_bytes"] += result_bytes * _WIRE_FACTOR[op]


def model_flops(cfg, shape, n_params_total: int) -> float:
    """MODEL_FLOPS = 6 N D (train) or 2 N D (forward), N the active
    parameters (a MoE layer counts its top-k experts)."""
    n_active = n_params_total
    if cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = sum(cfg.moe_layer_mask())
        per_expert = 3 * cfg.d_model * m.d_ff_expert
        n_active -= n_moe_layers * (m.num_experts - m.top_k) * per_expert
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n_active * tokens


def roofline_report(*, flops_per_device: float, bytes_per_device: float,
                    coll: Dict[str, Dict[str, float]], n_chips: int,
                    cfg=None, shape=None,
                    n_params_total: Optional[int] = None,
                    hw: Dict = HW_H100) -> Dict:
    """The three terms, the dominant one, and with ``cfg``, ``shape`` and
    ``n_params_total`` the model FLOPs, the useful share of the counted
    FLOPs and the roofline fraction (useful work at peak over the
    dominant term's time), with the reference's keys."""
    wire = sum(r["wire_bytes"] for r in coll.values())
    t_compute = flops_per_device / hw["peak_flops"]
    t_memory = bytes_per_device / hw["hbm_bw"]
    t_coll = wire / hw["link_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    rep = {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "wire_bytes_per_device": wire,
        "collectives": coll,
        "n_chips": n_chips,
    }
    if cfg is not None and shape is not None and n_params_total is not None:
        mf = model_flops(cfg, shape, n_params_total)
        rep["model_flops_total"] = mf
        rep["model_flops_per_device"] = mf / n_chips
        rep["hlo_flops_per_device"] = flops_per_device
        rep["useful_flops_ratio"] = (mf / n_chips) / max(flops_per_device,
                                                         1.0)
        bound = max(terms.values())
        rep["roofline_fraction"] = ((mf / n_chips) / hw["peak_flops"]) / max(
            bound, 1e-12)
    return rep


def format_row(arch: str, shape: str, rep: Dict) -> str:
    return (f"{arch:28s} {shape:12s} "
            f"comp={rep['compute_s']*1e3:9.3f}ms "
            f"mem={rep['memory_s']*1e3:9.3f}ms "
            f"coll={rep['collective_s']*1e3:9.3f}ms "
            f"dom={rep['dominant']:10s} "
            f"useful={rep.get('useful_flops_ratio', float('nan')):.3f} "
            f"roofline={rep.get('roofline_fraction', float('nan')):.3f}")
