"""Training the paper's encoders, roberta-large and deberta-xl, in the port
against the JAX reference on their reduced configs: every entry of
``test_torch_train.CASES`` (each PEFT method and full fine-tuning in LM
mode, AoT fc and BitFit classifying with an encoder's mean pooling) on
both, from the reference's init. One step's loss within 1e-5 relative of
the reference's under ``attn_impl="ref"`` and ``"chunked"``, every
gradient leaf within 1e-4 of its largest |g| against ``jax.grad``,
parameters after 3 AdamW steps within 1e-5 (but for the few elements in
AdamW's eps regime, :func:`eps_regime`); leaves are matched by their path
in the reference's tree (the untied head, learned positions and LayerNorm
biases included). Also the Kronecker factors at the encoders'
vocabularies and the training launcher on an encoder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import aot as JA
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro.train import step as JS
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.core import aot as PA
from repro_torch.launch import train as launcher
from repro_torch.train import step as PS

from test_torch_train import CASES, _case, _loss_fns, _port_to_ref

ENCODERS = ("roberta-large", "deberta-xl")
LR, STEPS = 1e-3, 3                 # test_torch_train._case's
EPS_REGIME = 1e-7                   # 10 x AdamW's eps (1e-8)


@pytest.fixture(scope="module", params=ENCODERS)
def enc_lm(request):
    """(reduced config, None, the reference's init at key 0, as numpy): the
    shape of ``tiny_lm`` that ``test_torch_train``'s helpers take."""
    cfg = jconfigs.reduced(jconfigs.get(request.param), repeats=2)
    return cfg, None, jax.device_get(JModel(cfg).init(jax.random.PRNGKey(0)))


def _by_path(tree):
    """{path: leaf} of a tree in the reference's layout."""
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_leaves(want, got, atol_of):
    """Every leaf of ``want`` (by path) against ``got``'s leaf of that path,
    within ``atol_of(path, leaf)`` (a number or an elementwise array); the
    two trees hold the same paths."""
    w, g = _by_path(want), _by_path(got)
    assert sorted(w) == sorted(g)
    for path, a in w.items():
        bad = np.abs(g[path] - a) > atol_of(path, a)
        assert not bad.any(), (path, np.abs(g[path] - a).max())


def eps_regime(nus):
    """{path: mask} of the elements whose reference second moment, bias
    corrected, lay in (0, ``EPS_REGIME``) after some step (``nus``: the
    reference's ``nu`` after steps 1, 2, ...). There AdamW's update
    ``m_hat / (sqrt(v_hat) + eps)`` is a steep function of a gradient of a
    few 1e-10 to 1e-7, whose float32 rounding differs between the two
    frameworks in its leading digit (a sum of 64 terms of ~1e-3 that
    cancel), so the two parameters may part by up to the learning rate per
    step; each such element is held within ``LR`` per step instead of
    1e-5. An element with a zero gradient (a token not in the batch) is
    not in the regime: both frameworks step it by exactly 0."""
    out = {}
    for t, nu in enumerate(nus, 1):
        for path, v in _by_path(nu).items():
            r = np.sqrt(v / (1.0 - 0.999 ** t))
            out[path] = out.get(path, False) | ((r > 0) & (r < EPS_REGIME))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grads_match_reference(enc_lm, name):
    """One step's loss and accuracy against the reference's under "ref"
    and "chunked"; every gradient leaf within 1e-4 of its largest |g|."""
    c = _case(enc_lm, name)
    jtr, jfr = JS.split_train(c["params"], c["pp"], c["method"])
    ptr, pfr = PS.split_train(c["pparams"], c["pp_port"], c["method"])
    jb = {k: jnp.asarray(v) for k, v in c["batches"][0].items()}
    pb = {k: torch.from_numpy(v) for k, v in c["batches"][0].items()}
    with torch.enable_grad():
        ploss, pmet = _loss_fns(c, None)[1](ptr, pfr, pb, None)
        grads = torch.autograd.grad(ploss, T.leaves(ptr), allow_unused=True)
    ploss = ploss.detach()
    for impl in ("chunked", "ref"):
        jmodel = JModel(c["cfg"], JOpts(attn_impl=impl, chunk_q=8,
                                        chunk_kv=8, remat=False))
        jloss_fn = _loss_fns(c, jmodel)[0]
        if impl == "ref":               # the loss and its gradients at once
            (jloss, jmet), jg = jax.jit(jax.value_and_grad(
                lambda t: jloss_fn(t, jfr, jb, None), has_aux=True))(jtr)
        else:
            jloss, jmet = jax.jit(jloss_fn, static_argnums=3)(jtr, jfr, jb,
                                                              None)
        assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert abs(float(pmet["acc"]) - float(jmet["acc"])) <= 1e-6
    jg = jax.device_get(jg)
    pg = _port_to_ref(c["cfg"], T.unflatten(ptr, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(T.leaves(ptr), grads)]))
    assert all(np.abs(a).max() > 0 for a in _by_path(jg).values())
    _same_leaves(jg, pg, lambda _, a: 1e-4 * np.abs(a).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_reference(enc_lm, name):
    """Parameters after 3 train steps (lr 1e-3) within 1e-5 of the
    reference's under "ref" (the elements of :func:`eps_regime` within lr
    per step), the metrics within 1e-5; the frozen
    backbone bitwise unchanged."""
    c = _case(enc_lm, name)
    jmodel = JModel(c["cfg"], JOpts(attn_impl="ref", remat=False))
    jinit, jstep = JS.make_train_step(jmodel, c["jt"],
                                      classify=c["classify"])
    pinit, pstep = PS.make_train_step(c["model"], c["pt"],
                                      classify=c["classify"])
    jtr, jfr = JS.split_train(c["params"], c["pp"], c["method"])
    ptr, pfr = PS.split_train(c["pparams"], c["pp_port"], c["method"])
    frozen0 = [x.clone() for x in T.leaves(pfr)]
    js, ps = jinit(jtr), pinit(ptr)
    jstep = jax.jit(jstep)
    nus = []
    for b in c["batches"]:
        js, jm = jstep(js, jfr, {k: jnp.asarray(v) for k, v in b.items()},
                       None)
        nus.append(jax.device_get(js["opt"].nu))
        ps, pm = pstep(ps, pfr, {k: torch.from_numpy(v)
                                 for k, v in b.items()}, None)
    assert sorted(pm) == sorted(jm)
    for k in pm:
        assert abs(float(pm[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), k
    assert c["pt"].lr == LR and len(nus) == STEPS
    regime = eps_regime(nus)
    _same_leaves(jax.device_get(js["trainable"]),
                 _port_to_ref(c["cfg"], ps["trainable"]),
                 lambda path, _: np.where(regime[path], LR * STEPS, 1e-5))
    assert all(torch.equal(a, b) for a, b in zip(frozen0, T.leaves(pfr)))


@pytest.mark.parametrize("vocab", [50265, 128100])
def test_kron_factors_at_the_encoders_vocabularies(vocab):
    assert PA.kron_factors(vocab) == JA.kron_factors(vocab)
    # the paper's own factors (section 3.3: roberta a=256, b=200; section
    # 4.1: deberta a=b=360)
    for a, b in ((256, 200), (360, 360)):
        if a * b >= vocab:
            assert PA.kron_factors(vocab, a, b) == JA.kron_factors(
                vocab, a, b)


@pytest.mark.parametrize("arch", ENCODERS)
def test_launcher_trains_an_encoder(arch, capsys, tmp_path):
    """``launch/train.py --arch`` trains an encoder through the same
    functions (LM mode, then classifying with a head), from step 0 in a
    fresh ``--ckpt-dir``."""
    assert launcher.main(["--device", "cpu", "--reduced", "--steps", "3",
                          "--arch", arch, "--method", "aot",
                          "--aot-mode", "kron",
                          "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "'step': 2" in out and "events: []" in out
    args = launcher.parser().parse_args(["--device", "cpu", "--reduced",
                                         "--arch", arch, "--method",
                                         "bitfit"])
    t = launcher.build(args, num_classes=2)
    assert t.model.cfg.is_encoder_only
    assert "lm_head" in t.params and "pos" in t.params["embed"]
    toks = torch.zeros(2, 8, dtype=torch.long)
    state, metrics = t.train_step(t.state, t.frozen, {
        "tokens": toks, "labels": torch.tensor([0, 1])}, None)
    assert torch.isfinite(metrics["loss"]) and state["step"] == 1
    assert configs.get(arch).num_layers in (24, 48)
