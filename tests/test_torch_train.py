"""The port's training path against the reference, on the CPU at
``tiny_lm`` scale (dropout 0 unless a test says otherwise): AoT's
reparametrizations and their fusion (``repro_torch.core.aot``), the PEFT
methods' loss, gradients and AdamW steps (``repro_torch.train.step``)
against ``jax.grad`` and the reference's ``train_step``, dropout, the
loop and the launcher, the bridge's way back, and the kernel wrappers'
refusal to cut the autograd graph."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aot as JA
from repro.core import peft as JP
from repro.data.pipeline import LMStream
from repro.data.tasks import ClassificationTask
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro.train import loop as jloop
from repro.train import step as JS
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.core import aot as PA
from repro_torch.core import peft as PP
from repro_torch.kernels import ops
from repro_torch.launch import train as launcher
from repro_torch.models.model import Model, ModelOptions
from repro_torch.train import loop as ploop
from repro_torch.train import step as PS


def _np(x):
    return np.asarray(jax.device_get(x))


# ---------------------------------------------------------------------------
# AoT: factors, rows, fusion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [2, 30, 128, 259, 1000, 32000, 49152,
                                   151936])
def test_kron_factors_equal(vocab):
    assert PA.kron_factors(vocab) == JA.kron_factors(vocab)
    assert PA.kron_factors(vocab, 8, -(-vocab // 8)) == JA.kron_factors(
        vocab, 8, -(-vocab // 8))


def _layer_params(rng, mode, d=16, r=4, vocab=30):
    if mode == "kron":
        a, b = JA.kron_factors(vocab)
        shapes = {"wl": (a, r), "wm": (b, r), "wr": (r * r, d)}
    else:
        shapes = {"w1": (d, r), "b1": (r,), "w2": (r, d), "b2": (d,)}
    return {k: rng.normal(size=s).astype(np.float32) * 0.3
            for k, s in shapes.items()}


@pytest.mark.parametrize("mode,nonlin", [("fc", "gelu"), ("fc", "relu"),
                                         ("fc", "tanh"), ("kron", "gelu")])
def test_rows_match_reference(mode, nonlin):
    rng = np.random.default_rng(0)
    lp = _layer_params(rng, mode)
    opt = dict(mode=mode, rank=4, nonlin=nonlin, dropout=0.0)
    ids = rng.integers(0, 30, (3, 7))
    tp = {k: torch.from_numpy(v) for k, v in lp.items()}
    if mode == "fc":
        e = rng.normal(size=(3, 7, 16)).astype(np.float32)
        want = JA.rows_fc(lp, jnp.asarray(e), JA.AoTOptions(**opt))
        got = PA.rows_fc(tp, torch.from_numpy(e), PA.AoTOptions(**opt))
    else:
        want = JA.rows_kron(lp, jnp.asarray(ids), JA.AoTOptions(**opt), 30)
        got = PA.rows_kron(tp, torch.from_numpy(ids), PA.AoTOptions(**opt))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=2e-5)


def _reparam(tiny_lm, mode, seed=3):
    """Random AoT parameters (rank 8, normal std 0.05, numpy leaves in the
    reference's tree) for ``mode``, so that every row is non-zero, and the
    reference's options."""
    cfg = tiny_lm[0]
    opt = JP.PEFTOptions(method="aot",
                         aot=JA.AoTOptions(mode=mode, rank=8, dropout=0.0))
    shapes = jax.eval_shape(lambda k: JP.init(k, cfg, opt),
                            jax.random.PRNGKey(seed))
    rng = np.random.default_rng(7)
    return opt, jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.05)
                             .astype(np.float32), shapes)


@pytest.mark.parametrize("mode", ["fc", "kron"])
def test_fuse_matches_reference(tiny_lm, mode):
    cfg, _, params = tiny_lm
    opt, pp = _reparam(tiny_lm, mode)
    want = jax.jit(lambda p, e: JA.fuse(p, cfg, opt.aot, embed=e,
                                        vocab_chunk=50))(
        pp["aot"], params["embed"]["tok"])["table"]
    bundle = bridge.peft_from_jax(pp, opt, device="cpu")
    embed = torch.from_numpy(np.array(params["embed"]["tok"]))
    got = PA.fuse(bundle["params"]["aot"], cfg, bundle["opt"].aot,
                  embed=embed, vocab_chunk=50)["table"]
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="embedding"):
        PA.fuse(bundle["params"]["aot"], cfg, PA.AoTOptions(mode="fc"))


def _port(tiny_lm, impl="ref"):
    cfg, _, params = tiny_lm
    return (Model(cfg, ModelOptions(attn_impl=impl), device="cpu"),
            bridge.params_from_jax(cfg, jax.device_get(params),
                                   device="cpu"))


def _tokens(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))


@pytest.mark.parametrize("mode", ["fc", "kron"])
def test_zero_init_gives_backbone_forward_bitwise(tiny_lm, mode):
    """The paper's init (W2 / W_R zero) makes the bias exactly 0."""
    model, params = _port(tiny_lm)
    cfg = tiny_lm[0]
    opt = PP.PEFTOptions(method="aot", aot=PA.AoTOptions(mode=mode, rank=8))
    pp = PP.init(cfg, opt, seed=2, device="cpu")
    toks = _tokens(cfg)
    assert torch.equal(model.logits(params, toks, PP.make(pp, opt)),
                       model.logits(params, toks))


@pytest.mark.parametrize("mode", ["fc", "kron"])
def test_fused_equals_on_the_fly_bitwise(tiny_lm, mode):
    """Fusion exactness (the reference's ``test_fusion_exactness``): the
    logits through the reparametrization equal those through its fused
    tables, bit for bit, under attn_impl="ref"."""
    cfg = tiny_lm[0]
    model, params = _port(tiny_lm)
    opt, pp = _reparam(tiny_lm, mode)
    bundle = bridge.peft_from_jax(pp, opt, device="cpu")
    fused = PA.fuse(bundle["params"]["aot"], cfg, bundle["opt"].aot,
                    embed=params["embed"]["tok"], vocab_chunk=50)
    fopt = PP.PEFTOptions(method="aot", aot=PA.AoTOptions(mode="fused"))
    toks = _tokens(cfg)
    want = model.logits(params, toks, bundle)
    assert torch.equal(model.logits(params, toks,
                                    PP.make({"aot": fused}, fopt)), want)
    # the same fused tables served through the kernel wrappers' plain
    # versions on the CPU (the rows differ from the rest of the stack by
    # the flash / ref attention's arithmetic only)
    served, _ = _port(tiny_lm, "kernel")
    np.testing.assert_allclose(
        served.logits(params, toks, PP.make({"aot": fused}, fopt)).numpy(),
        want.numpy(), rtol=0, atol=2e-5)


def test_training_methods_run_only_under_ref(tiny_lm):
    """AoT's fc reparametrization runs whole sequences under "ref" only;
    the serving entry points run under "ref" too, as the reference's take
    any attn_impl (the dry run costs them so): the mixed step's logits and
    written pool are the kernel path's within 2e-5 (ROADMAP C18), and
    prefill refuses the training-only method and gives the kernel path's
    logits and cache within 2e-5."""
    cfg = tiny_lm[0]
    model, params = _port(tiny_lm, "kernel")
    opt = PP.PEFTOptions(method="aot", aot=PA.AoTOptions(mode="fc", rank=4))
    pp = PP.make(PP.init(cfg, opt, device="cpu"), opt)
    with pytest.raises(NotImplementedError, match="attn_impl='ref'"):
        model.forward(params, _tokens(cfg), pp)
    ref, _ = _port(tiny_lm)
    tick = dict(token_rows=torch.zeros(2).int(),
                token_pos=torch.arange(2).int(),
                block_tables=torch.tensor([[1, 2]]).int())
    caches = [m.init_paged_cache(4, 8) for m in (ref, model)]
    lg_r, _ = ref.mixed_step(params, _tokens(cfg, 1, 2).T,
                             cache=caches[0], **tick)
    lg_k, _ = model.mixed_step(params, _tokens(cfg, 1, 2).T,
                               cache=caches[1], **tick)
    torch.testing.assert_close(lg_r, lg_k, atol=2e-5, rtol=0)
    for name in ("k", "v"):
        torch.testing.assert_close(caches[0][name], caches[1][name],
                                   atol=2e-5, rtol=0)
    with pytest.raises(NotImplementedError, match="runs only through"):
        ref.prefill(params, _tokens(cfg), pp, max_len=32)
    lg_r, cache_r, pos_r = ref.prefill(params, _tokens(cfg), None, max_len=32)
    lg_k, cache_k, pos_k = model.prefill(params, _tokens(cfg), None,
                                         max_len=32)
    assert pos_r == pos_k
    torch.testing.assert_close(lg_r, lg_k, atol=2e-5, rtol=0)
    for name in ("k", "v"):
        torch.testing.assert_close(cache_r[name], cache_k[name], atol=2e-5,
                                   rtol=0)
    with pytest.raises(ValueError, match="attn_impl"):
        Model(cfg, ModelOptions(attn_impl="pallas"), device="cpu")


# ---------------------------------------------------------------------------
# train steps against the reference
# ---------------------------------------------------------------------------

# (method, aot mode, classify)
CASES = {"aot_fc": ("aot", "fc", False), "aot_kron": ("aot", "kron", False),
         "bitfit": ("bitfit", "fc", False), "lora": ("lora", "fc", False),
         "adapters": ("adapters", "fc", False), "ptv1": ("ptv1", "fc", False),
         "ptv2": ("ptv2", "fc", False), "ft": ("ft", "fc", False),
         "aot_fc_classify": ("aot", "fc", True),
         "bitfit_classify": ("bitfit", "fc", True)}


def _case(tiny_lm, name):
    """Reference and port set up alike for one CASES entry: PEFT
    parameters perturbed from their init so that every gradient is
    non-trivial; batches of 4 x 16."""
    method, mode, classify = CASES[name]
    cfg, _, params = tiny_lm
    popt = JP.PEFTOptions(
        method=method, num_classes=2 if classify else 0, prompt_len=3,
        lora_rank=4, adapter_rank=8,
        aot=JA.AoTOptions(mode=mode, rank=4, dropout=0.0))
    pp = JP.init(jax.random.PRNGKey(1), cfg, popt)
    rng = np.random.default_rng(0)
    pp = jax.tree.map(lambda x: x + jnp.asarray(
        rng.normal(size=x.shape) * 0.05, x.dtype), pp)
    pp = jax.device_get(pp)
    if classify:
        task = ClassificationTask("t", cfg.vocab_size, 16, 2, seed=3)
        batches = [task.batch(4, i) for i in range(3)]
    else:
        stream = LMStream(cfg.vocab_size, 16, 4, seed=0)
        batches = [stream.next() for _ in range(3)]
    # lr 1e-3: AdamW divides each element's update by that element's own
    # gradient scale, so float32 rounding of a small gradient element
    # (within the 1e-4-of-the-largest bound held below) moves its
    # parameter by up to lr x its relative error; at 1e-2, ft's largest
    # difference after 3 steps is 5.9e-5 (one element of a W_gate)
    jt = JS.TrainConfig(peft=popt, lr=1e-3, loss_chunk=4)
    bundle = bridge.peft_from_jax(pp, popt, device="cpu")
    pt = PS.TrainConfig(peft=bundle["opt"], lr=1e-3, loss_chunk=4)
    model, pparams = _port(tiny_lm)
    return dict(cfg=cfg, method=method, classify=classify, params=params,
                pp=pp, batches=batches, jt=jt, pt=pt, model=model,
                pparams=pparams, pp_port=bundle["params"])


def _port_to_ref(cfg, tree):
    """A port trainable tree (or its gradients) in the reference's layout."""
    out = {"peft": bridge.to_numpy(tree["peft"])}
    if "backbone" in tree:
        out["backbone"] = bridge.params_to_jax(cfg, tree["backbone"])
    return out


def _loss_fns(c, jmodel):
    make = JS.make_classify_loss_fn if c["classify"] else JS.make_loss_fn
    pmake = PS.make_classify_loss_fn if c["classify"] else PS.make_loss_fn
    return make(jmodel, c["jt"]), pmake(c["model"], c["pt"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grads_match_reference(tiny_lm, name):
    """One step's loss within 1e-5 relative of the reference's under
    attn_impl="ref" and "chunked"; every gradient leaf within 1e-4 of its
    largest |g| against jax.grad."""
    c = _case(tiny_lm, name)
    jtr, jfr = JS.split_train(c["params"], c["pp"], c["method"])
    ptr, pfr = PS.split_train(c["pparams"], c["pp_port"], c["method"])
    jb = {k: jnp.asarray(v) for k, v in c["batches"][0].items()}
    pb = {k: torch.from_numpy(v) for k, v in c["batches"][0].items()}
    with torch.enable_grad():
        ploss, pmet = _loss_fns(c, None)[1](ptr, pfr, pb, None)
        grads = torch.autograd.grad(ploss, T.leaves(ptr), allow_unused=True)
    ploss = ploss.detach()
    for impl in ("ref", "chunked"):
        jmodel = JModel(c["cfg"], JOpts(attn_impl=impl, chunk_q=8,
                                        chunk_kv=8, remat=False))
        jloss_fn = _loss_fns(c, jmodel)[0]
        jloss, jmet = jax.jit(jloss_fn, static_argnums=3)(jtr, jfr, jb, None)
        assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert abs(float(pmet["acc"]) - float(jmet["acc"])) <= 1e-6
    jg = jax.jit(jax.grad(lambda t: jloss_fn(t, jfr, jb, None)[0]))(jtr)
    pg = _port_to_ref(c["cfg"], T.unflatten(ptr, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(T.leaves(ptr), grads)]))
    flat_j, tree_j = jax.tree_util.tree_flatten_with_path(jax.device_get(jg))
    flat_p = jax.tree.leaves(pg)
    assert len(flat_j) == len(flat_p)
    for (path, a), b in zip(flat_j, flat_p):
        top = np.abs(a).max()
        assert top > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * top,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_reference(tiny_lm, name):
    """Parameters after 3 train steps within 1e-5 of the reference's
    (attn_impl="ref"); the frozen backbone bitwise unchanged; optimizer
    state only for the trainable tree; the metrics' keys as the
    reference's."""
    c = _case(tiny_lm, name)
    jmodel = JModel(c["cfg"], JOpts(attn_impl="ref", remat=False))
    jinit, jstep = JS.make_train_step(jmodel, c["jt"],
                                      classify=c["classify"])
    pinit, pstep = PS.make_train_step(c["model"], c["pt"],
                                      classify=c["classify"])
    jtr, jfr = JS.split_train(c["params"], c["pp"], c["method"])
    ptr, pfr = PS.split_train(c["pparams"], c["pp_port"], c["method"])
    frozen0 = [x.clone() for x in T.leaves(pfr)]
    assert all(not x.requires_grad for x in T.leaves(pfr))
    js, ps = jinit(jtr), pinit(ptr)
    jstep = jax.jit(jstep)
    for b in c["batches"]:
        js, jm = jstep(js, jfr, {k: jnp.asarray(v) for k, v in b.items()},
                       None)
        ps, pm = pstep(ps, pfr, {k: torch.from_numpy(v)
                                 for k, v in b.items()}, None)
    assert sorted(pm) == sorted(jm)
    for k in pm:
        assert abs(float(pm[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), k
    assert ps["step"] == int(js["step"]) == 3
    want = jax.tree.leaves(jax.device_get(js["trainable"]))
    got = jax.tree.leaves(_port_to_ref(c["cfg"], ps["trainable"]))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(frozen0, T.leaves(pfr)))
    assert sum(x.numel() for x in T.leaves(ps["opt"].mu)) == sum(
        x.numel() for x in T.leaves(ps["trainable"]))


def test_chunked_ce_mask_and_chunks(tiny_lm):
    """The loss is the same for any chunking, and a mask averages over
    the positions it keeps."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(2, 10, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 30)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 30, (2, 10)))
    whole = PS.chunked_ce(h, w, labels, chunk=0, z_loss=1e-4)
    for chunk in (1, 3, 10):
        got = PS.chunked_ce(h, w, labels, chunk=chunk, z_loss=1e-4)
        assert all(abs(float(a) - float(b)) <= 1e-6
                   for a, b in zip(got, whole))
    mask = torch.zeros(2, 10)
    mask[:, :4] = 1
    masked = PS.chunked_ce(h, w, labels, chunk=3, z_loss=0.0, mask=mask)
    head = PS.chunked_ce(h[:, :4], w, labels[:, :4], chunk=0, z_loss=0.0)
    assert abs(float(masked[0]) - float(head[0])) <= 1e-6


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_statistics(p):
    gen = torch.Generator().manual_seed(0)
    n = 200_000
    out = PA._dropout(torch.ones(n), p, gen)
    kept = out != 0
    share = kept.float().mean().item()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(share - (1 - p)) <= 3 * sigma
    assert torch.all(out[kept] == torch.tensor(1.0 / (1.0 - p)))


@pytest.mark.parametrize("mode", ["fc", "kron"])
def test_dropout_only_with_a_generator(tiny_lm, mode):
    """rng=None runs without dropout (the forward of dropout 0); a step's
    generator drops rows reproducibly, layer by layer."""
    cfg = tiny_lm[0]
    model, params = _port(tiny_lm)
    _, pp = _reparam(tiny_lm, mode)
    toks = _tokens(cfg)
    out = {}
    for p in (0.0, 0.3):
        opt = PP.PEFTOptions(method="aot",
                             aot=PA.AoTOptions(mode=mode, rank=8, dropout=p))
        bundle = PP.make(bridge.peft_from_jax(pp, opt, device="cpu")
                         ["params"], opt)
        out[p] = model.forward(params, toks, bundle)
        if p:
            a = model.forward(params, toks, bundle, ploop.step_rng(0, 1))
            b = model.forward(params, toks, bundle, ploop.step_rng(0, 1))
            c = model.forward(params, toks, bundle, ploop.step_rng(0, 2))
    assert torch.equal(out[0.0], out[0.3])
    assert torch.equal(a, b) and not torch.equal(a, out[0.3])
    assert not torch.equal(a, c)


# ---------------------------------------------------------------------------
# the kernel wrappers refuse to cut the graph
# ---------------------------------------------------------------------------

def _t(*shape, grad=False, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).requires_grad_(grad)


def _i(*shape):
    return torch.zeros(shape, dtype=torch.int32)


WRAPPER_CALLS = {
    "aot_gather_add": lambda g: ops.aot_gather_add(
        _t(4, 8, grad=g), _t(10, 8), _i(4), norm=(_t(8), 1e-6)),
    "aot_gather_add_3d": lambda g: ops.aot_gather_add(
        _t(2, 2, 8), _t(10, 8, grad=g), _i(2, 2)),
    "aot_gather_add_multitask": lambda g: ops.aot_gather_add_multitask(
        _t(4, 8), _t(2, 10, 8), _i(4), _i(4), norm=(_t(8, grad=g), 1e-6)),
    "rms_norm": lambda g: ops.rms_norm(_t(2, 3, 8, grad=g), _t(8), 1e-6),
    "ragged_paged_attention": lambda g: ops.ragged_paged_attention(
        _t(2, 4, 8, grad=g), _t(3, 4, 2, 8), _t(3, 4, 2, 8), _i(1, 2),
        _i(2), _i(2)),
    "flash_attention": lambda g: ops.flash_attention(
        _t(1, 3, 4, 8), _t(1, 3, 2, 8, grad=g), _t(1, 3, 2, 8)),
    "decode_attention": lambda g: ops.decode_attention(
        _t(1, 4, 8), _t(1, 5, 2, 8), _t(1, 5, 2, 8, grad=g), 3),
    "paged_decode_attention": lambda g: ops.paged_decode_attention(
        _t(1, 4, 8, grad=g), _t(3, 4, 2, 8), _t(3, 4, 2, 8), _i(1, 2),
        _i(1)),
}


@pytest.fixture()
def kernel_branch(monkeypatch):
    """Every wrapper takes its kernel branch, and every kernel (and the
    ragged plan) fails the test if it is reached."""
    monkeypatch.setattr(ops, "_on_cpu", lambda *xs: False)
    launched = []

    def kernel(name):
        def fn(*a, **kw):
            launched.append(name)
            raise AssertionError(f"{name} launched")
        return fn
    for name in dir(ops):
        if name.endswith("_kernel") or name == "plan_tensor":
            monkeypatch.setattr(ops, name, kernel(name))
    return launched


@pytest.mark.parametrize("call", sorted(WRAPPER_CALLS))
def test_wrappers_refuse_grad_before_launch(kernel_branch, call):
    before = dict(ops.launches())
    with pytest.raises(RuntimeError, match="attn_impl='ref'"):
        WRAPPER_CALLS[call](True)
    assert kernel_branch == [] and ops.launches() == before
    with torch.no_grad():           # no graph to cut: the kernel is reached
        with pytest.raises(AssertionError, match="launched"):
            WRAPPER_CALLS[call](True)
    with pytest.raises(AssertionError, match="launched"):
        WRAPPER_CALLS[call](False)


def test_plain_versions_stay_differentiable():
    x = torch.randn(4, 8, requires_grad=True)
    table = torch.randn(10, 8, requires_grad=True)
    h, y = ops.aot_gather_add(x, table, torch.arange(4).int(),
                              norm=(torch.ones(8), 1e-6))
    (h.sum() + y.square().sum()).backward()
    assert x.grad is not None and table.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the loop, the launcher, the bridge back
# ---------------------------------------------------------------------------

def test_train_loop_history_matches_reference_keys(tiny_lm):
    cfg, _, params = tiny_lm
    popt = JP.PEFTOptions(method="bitfit")
    jinit, jstep = JS.make_train_step(JModel(cfg, JOpts(attn_impl="ref")),
                                      JS.TrainConfig(peft=popt, lr=1e-2,
                                                     loss_chunk=4))
    jtr, jfr = JS.split_train(params, JP.init(jax.random.PRNGKey(1), cfg,
                                              popt), "bitfit")
    jl = jloop.TrainLoop(train_step=jax.jit(jstep), frozen=jfr,
                         stream=LMStream(cfg.vocab_size, 8, 2), log_every=2)
    jl.run(jinit(jtr), 3)
    model, pparams = _port(tiny_lm)
    pinit, pstep = PS.make_train_step(model, PS.TrainConfig(
        peft=PP.PEFTOptions(method="bitfit"), lr=1e-2, loss_chunk=4))
    ptr, pfr = PS.split_train(pparams, PP.init(
        cfg, PP.PEFTOptions(method="bitfit"), device="cpu"), "bitfit")
    pl = ploop.TrainLoop(train_step=pstep, frozen=pfr,
                         stream=LMStream(cfg.vocab_size, 8, 2), log_every=2,
                         device="cpu")
    state = pl.run(pinit(ptr), 3)
    assert [sorted(h) for h in pl.history] == [sorted(h) for h in jl.history]
    assert [h["step"] for h in pl.history] == [0, 2] and state["step"] == 3
    for a, b in zip(pl.history, jl.history):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"]
    assert pl.events == []


def test_watchdog_fires_and_ckpt_waits():
    """The watchdog fires on a stalled step; a run waits for its pending
    checkpoint writes even when a step raises."""
    import time
    events = []
    wd = ploop.Watchdog(0.2, lambda dt: events.append(dt)).start()
    time.sleep(0.7)
    wd.stop()
    assert events, "watchdog did not fire on a stalled step"
    assert not wd._thread.is_alive()

    class Ckpt:
        waited = 0

        def wait(self):
            self.waited += 1

    def boom(state, frozen, batch, rng):
        raise RuntimeError("step failed")
    ckpt = Ckpt()
    loop = ploop.TrainLoop(train_step=boom, frozen={}, ckpt=ckpt,
                           stream=LMStream(8, 4, 1), device="cpu")
    with pytest.raises(RuntimeError, match="step failed"):
        loop.run({"step": 0}, 2)
    assert ckpt.waited == 1


@pytest.mark.parametrize("method", ["aot", "ptv1"])
def test_launcher_trains_on_the_cpu(method, capsys, tmp_path):
    assert launcher.main(["--device", "cpu", "--reduced", "--steps", "3",
                          "--method", method,
                          "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "'step': 2" in out and "events: []" in out
    assert "--mesh" in launcher.parser().format_help()


def test_bridge_round_trips(tiny_lm):
    cfg, _, params = tiny_lm
    host = jax.device_get(params)
    back = bridge.params_to_jax(cfg, bridge.params_from_jax(cfg, host,
                                                            device="cpu"))
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for method, mode, classes in (("aot", "fc", 2), ("aot", "kron", 0),
                                  ("ptv1", "fc", 3)):
        opt = JP.PEFTOptions(method=method, num_classes=classes,
                             aot=JA.AoTOptions(mode=mode, rank=4))
        pp = jax.device_get(JP.init(jax.random.PRNGKey(0), cfg, opt))
        bundle = bridge.peft_from_jax(pp, opt, device="cpu")
        assert bundle["opt"].aot.mode == mode
        assert bundle["opt"].num_classes == classes
        got = bridge.to_numpy(bundle["params"])
        assert jax.tree.structure(got) == jax.tree.structure(pp)
        for a, b in zip(jax.tree.leaves(pp), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), b)
        # the port's own init has the reference's tree
        mine = PP.init(cfg, bundle["opt"], device="cpu")
        assert jax.tree.structure(bridge.to_numpy(mine)) == \
            jax.tree.structure(pp)
        assert [x.shape for x in jax.tree.leaves(bridge.to_numpy(mine))] \
            == [x.shape for x in jax.tree.leaves(pp)]
