"""Parity of the port's float training side with the JAX package's, on the
CPU, and the port's own training runs held to the JAX package's bands.

No ``jax.random`` stream can be matched, so the float paths take the same
inputs passed across: JAX's initial params through
``convert.float_params_from_jax`` and JAX's Poisson spike train through a
``monkeypatch`` of the port's encoder.  Tolerances, stated per test:

* ``spike_surrogate``: forward exact, backward rtol 1e-6 against
  ``jax.vjp``; ``lif_step_float`` / ``run_lif_float``: spikes exact,
  membranes atol 1e-5, the reset path's gradient rtol 1e-5;
* ``snn_apply_float`` / ``snn_loss``: spikes and rates exact,
  membranes rtol 1e-6 / atol 1e-5, loss rtol 1e-5, gradients rtol
  1e-4 / atol 1e-6 (1e-5 on a hidden layer); ``quantize_params``: codes
  and scales exact;
* ``sgd`` / ``adamw`` (1 and 3 updates), the schedules and
  ``clip_by_global_norm``: rtol 1e-6; ``ann_apply``, ``ann_loss`` and
  ``convert_ann_to_snn``: rtol 1e-5;
* ``int_accuracy`` on the same codes, ``fit_or_load`` on the same cache
  file: exact.

The port's ``train_bptt`` (400 steps on ``make_dataset(2000, 400)``)
and ``train_converted`` (400 steps) run once, in a module fixture, and
must clear ``tests/test_snn_system.py``'s bands: 0.85 at T=10 and T=20 ≥
T=1 by BPTT, the pruned engine ≤ 1 spike a neuron with fewer adds and
≥ 0.6, conversion ≥ 0.75 at T=20.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snn_mnist as jcfgs
from repro.core import conversion as jconv
from repro.core import encoding as jenc
from repro.core import lif as jlif
from repro.core import snn as jsnn
from repro.core import train_snn as jtrain
from repro.data import digits as jdig
from repro.optim import optimizer as jopt
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.convert import float_params_from_jax
from repro_torch.core import conversion as tconv
from repro_torch.core import encoding as tenc
from repro_torch.core import energy as ten
from repro_torch.core import lif as tlif
from repro_torch.core import prng as tprng
from repro_torch.core import snn as tsnn
from repro_torch.core import train_snn as ttrain
from repro_torch.data import digits as tdig
from repro_torch.optim import optimizer as topt

DEV = "cpu"


def _cfgs(sizes, **kw):
    return (dataclasses.replace(jcfgs.SNN_CONFIG, layer_sizes=sizes, **kw),
            dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=sizes, **kw))


def _jax_params(sizes, seed, gain=1.0):
    jp = jsnn.snn_init(jax.random.PRNGKey(seed),
                       jsnn.SNNConfig(layer_sizes=sizes))
    npp = {"layers": [{"w": np.asarray(l["w"]) * np.float32(gain)}
                      for l in jp["layers"]]}
    return ({"layers": [{"w": jnp.asarray(l["w"])} for l in npp["layers"]]},
            float_params_from_jax(npp, device=DEV))


def _close(got: torch.Tensor, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# surrogate spike and the float LIF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slope", [1.0, 4.0, 25.0])
def test_spike_surrogate_matches_jax(slope):
    """Forward exact; backward rtol 1e-6 against ``jax.vjp``."""
    rng = np.random.default_rng(int(slope))
    x = rng.normal(0, 1, (64, 32)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e-8, -1e-8]
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tlif.spike_surrogate(xt, slope)
    want, vjp = jax.vjp(lambda v: jlif.spike_surrogate(v, slope),
                        jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    _close(gx, vjp(jnp.asarray(g))[0], rtol=1e-6)


@pytest.mark.parametrize("sizes,batch", [((784, 10), 128), ((64, 32), 16)])
@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_run_lif_float_matches_jax(sizes, batch, threshold):
    """Spikes exact, ``v_trace`` and the final membrane atol 1e-5."""
    n_in, n_out = sizes
    rng = np.random.default_rng(n_in + batch)
    s = (rng.random((20, batch, n_in)) < 0.3).astype(np.float32)
    w = (rng.normal(0, 2.0 / np.sqrt(n_in), sizes)).astype(np.float32)
    jc = jlif.LIFConfig(v_threshold=threshold)
    tc = tlif.LIFConfig(v_threshold=threshold)
    assert tc.beta == jc.beta == 1 / 16
    js, jv, jf = jlif.run_lif_float(jnp.asarray(s), jnp.asarray(w), jc)
    ts, tv, tf = tlif.run_lif_float(torch.from_numpy(s), torch.from_numpy(w),
                                    tc)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(tv, jv, rtol=0, atol=1e-5)
    _close(tf.v, jf.v, rtol=0, atol=1e-5)
    assert 0 < float(ts.mean()) < 0.9                # the layer fires
    init = tlif.init_state_float((3, 4), tc, device=DEV)
    assert init.v.dtype == torch.float32 and float(init.v.abs().sum()) == 0


def _reset_grad(lif_mod, lif_cfg, cur, g, detach=False):
    """d(Σ g·v_trace)/d current over a few steps of ``lif_step_float``
    (torch side when ``lif_mod`` is the port's; ``detach`` cuts the
    surrogate gradient out of the reset)."""
    if lif_mod is jlif:
        def f(c):
            st, out = jlif.init_state_float(c.shape[1:], lif_cfg), []
            for t in range(c.shape[0]):
                st, _ = jlif.lif_step_float(st, c[t], lif_cfg)
                out.append(st.v)
            return jnp.stack(out)
        _, vjp = jax.vjp(f, jnp.asarray(cur))
        return np.asarray(vjp(jnp.asarray(g))[0])
    c = torch.from_numpy(cur).requires_grad_(True)
    st, out = tlif.init_state_float(cur.shape[1:], lif_cfg, device=DEV), []
    for t in range(cur.shape[0]):
        if detach:
            v_int = st.v + c[t]
            v_leak = v_int - v_int * lif_cfg.beta
            spike = tlif.spike_surrogate(v_leak - float(lif_cfg.v_threshold))
            st = tlif.LIFStateFloat(v=v_leak * (1.0 - spike.detach()))
        else:
            st, _ = tlif.lif_step_float(st, c[t], lif_cfg)
        out.append(st.v)
    (gc,) = torch.autograd.grad(torch.stack(out), c, torch.from_numpy(g))
    return gc.numpy()


def test_reset_gradient_flows_through_the_spike():
    """The hard reset ``v_leak·(1 − s) + v_rest·s`` carries the surrogate
    gradient through ``s``: the port's gradient equals JAX's (rtol 1e-5,
    atol 1e-6) and differs from the detached-reset idiom's."""
    rng = np.random.default_rng(8)
    cur = rng.normal(0.5, 0.6, (6, 32, 10)).astype(np.float32)
    g = rng.normal(0, 1, cur.shape).astype(np.float32)
    cfg_t = tlif.LIFConfig(v_threshold=1.0)
    want = _reset_grad(jlif, jlif.LIFConfig(v_threshold=1.0), cur, g)
    got = _reset_grad(tlif, cfg_t, cur, g)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    detached = _reset_grad(tlif, cfg_t, cur, g, detach=True)
    assert np.abs(detached - want).max() > 1e-2


# ---------------------------------------------------------------------------
# the float SNN: forward, loss, gradients, quantization
# ---------------------------------------------------------------------------

def _inject_jax_spikes(monkeypatch, px, key, num_steps):
    spikes = np.array(jenc.poisson_encode_jax(jnp.asarray(px), key,
                                              num_steps))
    calls = []

    def encoder(pixels01, steps, *, generator):
        assert steps == num_steps and isinstance(generator, torch.Generator)
        calls.append(tuple(pixels01.shape))
        return torch.from_numpy(spikes)
    monkeypatch.setattr(tenc, "poisson_encode_float", encoder)
    return calls


@pytest.mark.parametrize("qat", [True, False])
@pytest.mark.parametrize("sizes,batch", [((784, 10), 128), ((64, 32, 10), 64)])
def test_snn_apply_float_and_loss_match_jax(monkeypatch, sizes, batch, qat):
    """JAX's spike train injected into the port: output spikes and rates
    exact, membranes rtol 1e-6 / atol 1e-5 (they reach ±20 without QAT),
    loss rtol 1e-5, the weight gradients (through fake-quant, the
    surrogate and the reset) rtol 1e-4 with atol 1e-6 on the output
    layer and 1e-5 on a hidden one."""
    rng = np.random.default_rng(sum(sizes) + qat)
    px = rng.random((batch, sizes[0])).astype(np.float32)
    labels = rng.integers(0, sizes[-1], batch).astype(np.int32)
    key = jax.random.PRNGKey(sum(sizes))
    jc, tc = _cfgs(sizes, qat=qat)
    jp, tp = _jax_params(sizes, seed=len(sizes) + qat)
    calls = _inject_jax_spikes(monkeypatch, px, key, jc.num_steps)
    gen = torch.Generator()
    jout = jsnn.snn_apply_float(jp, jnp.asarray(px), key, jc)
    tout = tsnn.snn_apply_float(tp, torch.from_numpy(px), gen, tc)
    np.testing.assert_array_equal(tout["spikes"].numpy(),
                                  np.asarray(jout["spikes"]))
    np.testing.assert_array_equal(tout["rates"].numpy(),
                                  np.asarray(jout["rates"]))
    _close(tout["v_trace"], jout["v_trace"], rtol=1e-6, atol=1e-5)
    assert 0 < float(tout["rates"].mean()) < 0.9
    (jl, jaux), jg = jax.value_and_grad(jsnn.snn_loss, has_aux=True)(
        jp, jnp.asarray(px), jnp.asarray(labels), key, jc)
    leaves = [l["w"].clone().requires_grad_(True) for l in tp["layers"]]
    tl, taux = tsnn.snn_loss({"layers": [{"w": w} for w in leaves]},
                             torch.from_numpy(px), torch.from_numpy(labels),
                             gen, tc)
    grads = torch.autograd.grad(tl, leaves)
    _close(tl, jl, rtol=1e-5)
    _close(taux["loss"], jaux["loss"], rtol=1e-5)
    assert float(taux["acc"]) == float(jaux["acc"])
    for i, (g, want) in enumerate(zip(grads, jg["layers"])):
        assert float(g.abs().max()) > 0
        # a hidden layer's gradient passes a second surrogate and sums
        # batch × T terms that cancel, so the two packages' float32
        # orderings of the same products differ there by more than 1e-6
        hidden = i < len(grads) - 1
        _close(g, want["w"], rtol=1e-4, atol=1e-5 if hidden else 1e-6,
               what=f"layer {i}")
    assert calls == [(batch, sizes[0])] * 2


@pytest.mark.parametrize("qat", [True, False])
@pytest.mark.parametrize("sizes,gain", [((784, 10), 1.0), ((784, 10), 10.0),
                                        ((64, 32, 10), 1.0)])
def test_quantize_params_matches_jax(sizes, gain, qat):
    """Codes (int16, clipped to 9 bits) and scales exactly equal."""
    jc, tc = _cfgs(sizes, qat=qat)
    jp, tp = _jax_params(sizes, seed=sum(sizes), gain=gain)
    want = jsnn.quantize_params(jp, jc)
    got = tsnn.quantize_params(tp, tc)
    for g, w in zip(got["layers"], want["layers"]):
        assert g["w_q"].dtype == torch.int16
        np.testing.assert_array_equal(g["w_q"].numpy(), np.asarray(w["w_q"]))
        assert np.float32(g["scale"]) == np.asarray(w["scale"])
    if gain > 1:                                     # the clip is exercised
        assert int(got["layers"][0]["w_q"].max()) == 255


def test_snn_init_and_float_encoder():
    cfg = tcfgs.SNN_CONFIG_DEEP
    g = torch.Generator()
    g.manual_seed(3)
    p = tsnn.snn_init(g, cfg, device=DEV)
    assert [tuple(l["w"].shape) for l in p["layers"]] == \
        [(784, 128), (128, 64), (64, 10)]
    for l, fan_in in zip(p["layers"], cfg.layer_sizes):
        assert l["w"].dtype == torch.float32
        assert abs(float(l["w"].std()) * fan_in ** 0.5 / 2 - 1) < 0.1
    px = torch.rand(200, 50, generator=g)
    s = tenc.poisson_encode_float(px, 400, generator=g)
    assert s.dtype == torch.float32 and set(s.unique().tolist()) <= {0., 1.}
    assert float((s.mean(0) - px).abs().max()) < 0.1  # rate ≈ intensity
    g2 = torch.Generator()
    g2.manual_seed(5)
    a = tenc.poisson_encode_float(px, 3, generator=g2)
    g2.manual_seed(5)
    assert torch.equal(a, tenc.poisson_encode_float(px, 3, generator=g2))


# ---------------------------------------------------------------------------
# optimizers, schedules, clipping
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"layers": [{"w": (rng.normal(0, scale, (784, 10))
                              .astype(np.float32))},
                       {"w": rng.normal(0, scale, (10,)).astype(np.float32)}]}


def _to(tree, kind):
    f = jnp.asarray if kind == "jax" else torch.from_numpy
    return {"layers": [{"w": f(l["w"])} for l in tree["layers"]]}


def _tree_close(got, want, rtol, what):
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        _close(g["w"], w["w"], rtol=rtol, what=f"{what}[{i}]")


@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("name,kw", [
    ("adamw", {"weight_decay": 1e-4}), ("adamw", {}),
    ("adamw", {"b1": 0.8, "b2": 0.99, "eps": 1e-6, "weight_decay": 0.1}),
    ("sgd", {}), ("sgd", {"momentum": 0.5, "nesterov": True})])
def test_optimizers_match_jax(name, kw, n_updates):
    """Updates, params and state after 1 and 3 updates from the same
    state and grads: rtol 1e-6."""
    rng = np.random.default_rng(n_updates + len(kw))
    j = getattr(jopt, name)(jopt.cosine_schedule(2e-3, 10), **kw)
    t = getattr(topt, name)(topt.cosine_schedule(2e-3, 10), **kw)
    p = _tree(rng)
    jp, tp = _to(p, "jax"), _to(p, "torch")
    js, ts = j.init(jp), t.init(tp)
    for k in range(n_updates):
        g = _tree(rng, scale=10.0 ** -k)
        ju, js = j.update(_to(g, "jax"), js, jp)
        tu, ts = t.update(_to(g, "torch"), ts, tp)
        _tree_close(tu, ju, 1e-6, f"update {k}")
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _tree_close(tp, jp, 1e-6, f"params {k}")
    assert ts.step == int(js.step) == n_updates
    for f in ts._fields[1:]:
        _tree_close(getattr(ts, f), getattr(js, f), 1e-6, f)


@pytest.mark.parametrize("make", [
    lambda m: m.constant_schedule(3e-3),
    lambda m: m.cosine_schedule(2e-3, 1500),
    lambda m: m.cosine_schedule(1e-2, 7, final_frac=0.0),
    lambda m: m.linear_warmup_cosine(2e-3, 100, 1500),
    lambda m: m.linear_warmup_cosine(1e-3, 0, 20, final_frac=0.3)])
def test_schedules_match_jax(make):
    j, t = make(jopt), make(topt)
    for step in (0, 1, 7, 50, 99, 100, 101, 750, 1499, 1500, 4000):
        want = float(j(jnp.int32(step)))
        got = t(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(2))
    jc, jn = jopt.clip_by_global_norm(_to(g, "jax"), max_norm)
    tc, tn = topt.clip_by_global_norm(_to(g, "torch"), max_norm)
    _close(tn, jn, rtol=1e-6)
    _close(topt.global_norm(_to(g, "torch")),
           jopt.global_norm(_to(g, "jax")), rtol=1e-6)
    _tree_close(tc, jc, 1e-6, "clipped")
    if max_norm == 1.0:                              # the clip is exercised
        _close(topt.global_norm(tc), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# ANN→SNN conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(784, 10), (64, 32, 10)])
def test_conversion_matches_jax(sizes):
    """``ann_apply``, ``ann_loss`` and ``convert_ann_to_snn`` on JAX's
    initial ANN params: rtol 1e-5."""
    rng = np.random.default_rng(len(sizes))
    jp = jconv.ann_init(jax.random.PRNGKey(len(sizes)), sizes)
    npp = {"layers": [{"w": np.asarray(l["w"]),
                       "b": rng.normal(0, 0.1, l["b"].shape)}
                      for l in jp["layers"]]}
    jp = {"layers": [{k: jnp.asarray(v, jnp.float32) for k, v in l.items()}
                     for l in npp["layers"]]}
    tp = float_params_from_jax(npp, device=DEV)
    assert set(tp["layers"][0]) == {"w", "b"}
    x = rng.random((128, sizes[0])).astype(np.float32)
    y = rng.integers(0, sizes[-1], 128).astype(np.int32)
    _close(tconv.ann_apply(tp, torch.from_numpy(x)),
           jconv.ann_apply(jp, jnp.asarray(x)), rtol=1e-5, atol=1e-6)
    tl, taux = tconv.ann_loss(tp, torch.from_numpy(x), torch.from_numpy(y))
    jl, jaux = jconv.ann_loss(jp, jnp.asarray(x), jnp.asarray(y))
    _close(tl, jl, rtol=1e-5)
    assert float(taux["acc"]) == float(jaux["acc"])
    got = tconv.convert_ann_to_snn(tp, torch.from_numpy(x[:100]))
    want = jconv.convert_ann_to_snn(jp, jnp.asarray(x[:100]))
    assert all(set(l) == {"w"} for l in got["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        _close(g["w"], w["w"], rtol=1e-5)
    g = torch.Generator()
    g.manual_seed(0)
    init = tconv.ann_init(g, sizes, device=DEV)
    assert [tuple(l["w"].shape) for l in init["layers"]] == \
        [(a, b) for a, b in zip(sizes[:-1], sizes[1:])]
    assert all(float(l["b"].abs().sum()) == 0 for l in init["layers"])


# ---------------------------------------------------------------------------
# the port's own training runs, and the integer engine on their codes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    ds = tdig.make_dataset(n_train=2000, n_test=400, seed=0)
    params = ttrain.train_bptt(tcfgs.SNN_CONFIG, ds, steps=400, seed=0,
                               device=DEV)
    conv = ttrain.train_converted(tcfgs.SNN_CONFIG, ds, steps=400, seed=0,
                                  device=DEV)
    return (ds, tsnn.quantize_params(params, tcfgs.SNN_CONFIG),
            tsnn.quantize_params(conv, tcfgs.SNN_CONFIG))


def test_bptt_reaches_the_paper_band(trained):
    """Paper: ~89% by T=10; the short budget must clear 0.85 at T=10, and
    T=20 must be no worse than T=1."""
    ds, params_q, _ = trained
    w = params_q["layers"][0]["w_q"]
    assert w.dtype == torch.int16 and -256 <= int(w.min()) <= int(w.max()) \
        <= 255
    accs = {t: ttrain.int_accuracy(params_q, tcfgs.SNN_CONFIG, ds.x_test,
                                   ds.y_test, num_steps=t, device=DEV)[0]
            for t in (1, 10, 20)}
    assert accs[10] >= 0.85, accs
    assert accs[20] >= accs[1], accs


def test_pruned_engine_on_trained_codes(trained):
    """≤ 1 spike a neuron, fewer adds than unpruned, accuracy ≥ 0.6."""
    ds, params_q, _ = trained
    px = torch.from_numpy((ds.x_test[:200] * 255).astype(np.uint8))
    st = tprng.seed_state(5, tuple(px.shape), device=DEV)
    on = tsnn.snn_apply_int(params_q, px, st, tcfgs.SNN_CONFIG_PRUNED)
    off = tsnn.snn_apply_int(params_q, px, st, tcfgs.SNN_CONFIG)
    assert int(on["spike_counts"].max()) <= 1
    assert int(on["active_adds"].sum()) < int(off["active_adds"].sum())
    assert (on["pred"].numpy() == ds.y_test[:200]).mean() >= 0.6


def test_conversion_route_reaches_its_band(trained):
    ds, _, conv_q = trained
    acc, _ = ttrain.int_accuracy(conv_q, tcfgs.SNN_CONFIG, ds.x_test,
                                 ds.y_test, num_steps=20, device=DEV)
    assert acc >= 0.75, acc


@pytest.mark.parametrize("num_steps", [1, 10])
@pytest.mark.parametrize("route", ["bptt", "convert"])
def test_int_accuracy_matches_jax(trained, num_steps, route):
    """The same codes through both packages' ``int_accuracy`` (the
    reference backend on the CPU): accuracy and adds per image exact."""
    ds, bptt_q, conv_q = trained
    params_q = bptt_q if route == "bptt" else conv_q
    jparams = {"layers": [{"w_q": jnp.asarray(l["w_q"].numpy()),
                           "scale": jnp.float32(l["scale"])}
                          for l in params_q["layers"]]}
    got = ttrain.int_accuracy(params_q, tcfgs.SNN_CONFIG, ds.x_test[:300],
                              ds.y_test[:300], num_steps=num_steps,
                              batch=128, device=DEV)
    want = jtrain.int_accuracy(jparams, jcfgs.SNN_CONFIG, ds.x_test[:300],
                               ds.y_test[:300], num_steps=num_steps,
                               batch=128)
    assert got == want
    ops = ten.snn_op_counts(np.asarray([got[1]["adds_per_img"]]),
                            num_steps=num_steps)
    assert ops.multiplications == 0 and ops.additions > 0


@pytest.fixture
def small_datasets(monkeypatch):
    """Both packages' ``fit_or_load`` build ``make_dataset(seed=0)``; a
    small one keeps the test short."""
    for mod in (jdig, tdig):
        full = mod.make_dataset
        monkeypatch.setattr(mod, "make_dataset",
                            lambda n_train=6000, n_test=1000, seed=0, f=full:
                            f(160, 10, seed))


def test_fit_or_load_reads_the_jax_cache(tmp_path, small_datasets):
    """A cache the JAX package's format holds loads in the port to JAX's
    float params and codes, exactly; one the port writes (after 3 steps of
    its own training) loads in JAX alike."""
    jax_cache = tmp_path / "jax.npz"
    w = np.asarray(jsnn.snn_init(jax.random.PRNGKey(1), jcfgs.SNN_CONFIG)
                   ["layers"][0]["w"])
    np.savez(jax_cache, w0=w)
    for cache in (str(jax_cache), str(tmp_path / "sub" / "torch.npz")):
        tp, tq, tds = ttrain.fit_or_load(cache=cache, steps=3, device=DEV)
        jp, jq, jds = jtrain.fit_or_load(cache=cache)
        np.testing.assert_array_equal(tp["layers"][0]["w"].numpy(),
                                      np.asarray(jp["layers"][0]["w"]))
        np.testing.assert_array_equal(tq["layers"][0]["w_q"].numpy(),
                                      np.asarray(jq["layers"][0]["w_q"]))
        np.testing.assert_array_equal(tds.x_test, jds.x_test)
    np.testing.assert_array_equal(np.load(jax_cache)["w0"], w)
