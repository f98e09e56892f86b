"""The pure-Python gates of the port's card scripts, on the CPU: phase 2's
check of the redesigned kernels' ptxas output, phase 6's comparison of
kernel logits with the plain versions' (near ties). The phases themselves
need the card (chip_smoke.py)."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke")

FLASH = "_ZN12_GLOBAL__N_116flash_mma_kernelILi64ELb1EEEvPKT_"
DECODE = ("_ZN12_GLOBAL__N_119decode_split_kernelI13__nv_bfloat16Lb1ELi64ELi4E"
          "EEvv")


def _ptxas(name, regs, spill):
    return (f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, 380 bytes cmem[0]\n")


LOGS = {
    "clean": ({"flash_attention": _ptxas(FLASH, 168, 0),
               "decode_attention": _ptxas(DECODE, 72, 0)}, None),
    "spill": ({"flash_attention": _ptxas(FLASH, 255, 40),
               "decode_attention": _ptxas(DECODE, 72, 0)}, "spill"),
    "missing": ({"flash_attention": _ptxas(FLASH, 168, 0),
                 "decode_attention": _ptxas("other_kernel", 40, 0)},
                "missing"),
    "cached": ({"flash_attention": "cached",
                "decode_attention": "cached"}, None),
}


@pytest.mark.parametrize("case", sorted(LOGS))
def test_phase2_refuses_spills_of_redesigned_kernels(case):
    logs, fault = LOGS[case]
    if fault:
        with pytest.raises(AssertionError, match=fault):
            cs.redesigned(logs)
        return
    new = cs.redesigned(logs)
    if case == "cached":
        assert new == {}
    else:
        assert new == {"flash_mma_kernel": ["ILi64ELb1EE:168r/0s"],
                       "decode_split_kernel":
                           ["I13__nv_bfloat16Lb1ELi64ELi4EE:72r/0s"]}


def _logits(rows=6, vocab=50, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, vocab, generator=g) * 3


def test_against_plain_identical_logits():
    lg = _logits()
    r = cs.against_plain(lg, lg.clone())
    assert r["ok"] and r["near_ties"] == 0 and r["tie_gap"] == 0.0
    assert r["logits_max_abs_err"] == 0.0


@pytest.mark.parametrize("gap,ok", [(0.01, True), (0.5, False)])
def test_against_plain_counts_a_flip_and_holds_its_gap(gap, ok):
    lg_p = _logits()
    best = lg_p.argmax(-1)
    second = lg_p.clone()
    second[0, best[0]] = -1e9
    other = second[0].argmax()
    lg_p[0, other] = lg_p[0, best[0]] - gap          # runner-up at ``gap``
    lg_k = lg_p.clone()
    lg_k[0, other] += gap + 1e-3                      # the kernels pick it
    r = cs.against_plain(lg_k, lg_p)
    assert r["near_ties"] == 1
    assert r["tie_gap"] == pytest.approx(gap, abs=1e-5)
    assert r["ok"] is ok
