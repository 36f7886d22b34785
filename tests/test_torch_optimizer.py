"""AdamW with DFP-8 moments (``repro_torch.training.optimizer``) against the
reference's ``apply_updates`` under ``jax.jit`` (as its Trainer runs it),
and the counterparts of the reference's optimizer tests
(``tests/test_training.py``, ``tests/test_trained_quant.py:141-198``).

The tree: a stacked block leaf (the port's per-layer list against the
reference's (L, K, N) leaf), a norm, an embedding, a ttq site (its
``ttq_scales``) and an INQ site (``w``, ``inq_mask``, ``inq_scales``), from
numpy.  Where the clip is inactive the DFP-8 mantissas and exponents of m
and v are equal bit for bit (and the float32 moments too): the port
computes the reference's update as XLA:CPU compiles it -- the two moment
updates and the parameter update as fmas, (m / b1c) / den as
m / (b1c * den) -- in float64 emulation (``optimizer._fma``).

Parameters: of a few in 10^4 coordinates one to five float32 ulps apart,
where the libraries still round one of the update's operations otherwise.
Each of the update's roundings is one float32 ulp of |p| or of lr times an
update of magnitude about 1, so four of them bound the gap: PARAM_TOL
(2**-21 (|p| + lr)).

Where the clip is active, the clip factor is a quotient of the global norm,
whose float32 sum the port takes per layer and the reference per stacked
leaf: it can differ by an ulp, and the float32 moments with it.  Then every
float32 moment is held within four ulps of its leaf's largest (2**-20 of
it) and each DFP-8 moment within one mantissa step of its row; the
parameters to PARAM_TOL."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jopt
from repro_torch.training import optimizer as topt

L = 3
PARAM_TOL = 2.0**-21


def _tree(rng):
    def leaf(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    params = {"blocks": {"w": leaf(L, 64, 96), "norm": leaf(L, 96)}, "embed": leaf(200, 96),
              "site": {"w": leaf(64, 32), "inq_mask": (rng.random((64, 32)) < 0.3).astype(np.float32),
                       "inq_scales": leaf(4, 32)},
              "t": {"w": leaf(32, 48), "ttq_scales": np.abs(leaf(2, 2, 48))}}
    grads = jax.tree.map(lambda p: leaf(*p.shape, scale=1e-2), params)
    grads["site"]["inq_mask"] = np.zeros((64, 32), np.float32)
    return params, grads


def _port(tree):
    """A reference tree (numpy, stacked blocks) as the port's: blocks a list
    of per-layer dicts, None kept."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return None if t is None else torch.from_numpy(np.array(t))

    out = conv(tree)
    out["blocks"] = [jax.tree.map(lambda x: x[i].clone(), out["blocks"]) for i in range(L)]
    return out


def _flat(tree, path=""):
    """path -> numpy of a reference tree, or of a port tree with its blocks
    stacked back."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, list):
        layers = [_flat(t, path) for t in tree]
        return {k: np.stack([lay[k] for lay in layers]) for k in layers[0]}
    if tree is None:
        return {}
    return {path: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


def _cfg(bits, clip):
    return jopt.OptConfig(lr=1e-2, warmup_steps=0, state_bits=bits, weight_decay=0.01, grad_clip=clip)


def _tcfg(cfg):
    return topt.OptConfig(**dataclasses.asdict(cfg))


def _steps(bits, clip, seed, n_warm=2):
    """The reference's jitted step from a state it reached in ``n_warm``
    steps, and the port's from that same state: (reference (params, state),
    port (params, state), reference metrics, port metrics)."""
    rng = np.random.default_rng(seed)
    params, grads = _tree(rng)
    cfg = _cfg(bits, clip)
    step = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, cfg))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_state(jp, cfg)
    for _ in range(n_warm):
        scale = float(1 + rng.normal())
        jp, js, _ = step(jp, jax.tree.map(lambda g: jnp.asarray(g) * scale, grads), js)
    p0, s0 = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    jp, js, jm = step(jp, jax.tree.map(jnp.asarray, grads), js)
    ts = {"step": torch.tensor(s0["step"]), "m": _port(s0["m"]), "v": _port(s0["v"])}
    tp, ts, tm = topt.apply_updates(_port(p0), _port(grads), ts, _tcfg(cfg))
    return (jp, js), (tp, ts), jm, tm


@pytest.mark.parametrize("bits", [8, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_updates_matches_reference_clip_inactive(bits, seed):
    (jp, js), (tp, ts), jm, tm = _steps(bits, clip=1e6, seed=seed)
    assert float(tm["lr"]) == float(jm["lr"])
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    for key in ("m", "v"):
        want, got = _flat(js[key]), _flat(ts[key])
        assert sorted(got) == sorted(want)
        for path, arr in want.items():
            assert got[path].dtype == arr.dtype and np.array_equal(got[path], arr), (key, path)
    if bits == 8:  # scale leaves keep float32 moments, everything else is a DFP-8 entry
        assert set(_flat(js["m"])) >= {"/embed/q", "/embed/e", "/blocks/w/q", "/t/ttq_scales", "/site/inq_scales"}
    _check_params(jp, tp)


@pytest.mark.parametrize("bits", [8, 32])
@pytest.mark.parametrize("seed", [0, 2])
def test_apply_updates_matches_reference_clip_active(bits, seed):
    (jp, js), (tp, ts), jm, tm = _steps(bits, clip=1.0, seed=seed)
    assert float(jm["grad_norm"]) > 1.0
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    for key in ("m", "v"):
        want, got = _flat(js[key]), _flat(ts[key])
        assert sorted(got) == sorted(want)
        for path, arr in want.items():
            if path.endswith("/e"):
                continue
            if path.endswith("/q"):
                e = want[path[:-1] + "e"]
                ref = arr.astype(np.float64) * 2.0**e
                out = got[path].astype(np.float64) * 2.0 ** got[path[:-1] + "e"]
                assert np.all(np.abs(out - ref) <= 2.0**e), (key, path)  # one mantissa step of the row
            else:
                tol = 2.0**-20 * np.abs(arr).max()  # four ulps of the leaf's largest moment
                np.testing.assert_allclose(got[path], arr, rtol=0, atol=tol, err_msg=f"{key}{path}")
    _check_params(jp, tp)


def _check_params(jp, tp):
    want, got = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert np.all(np.abs(got[path] - arr) <= PARAM_TOL * (np.abs(arr) + 1e-2)), path
    mask = want["/site/inq_mask"] > 0
    assert np.array_equal(got["/site/inq_mask"], want["/site/inq_mask"])
    assert np.array_equal(got["/site/w"][mask], want["/site/w"][mask])


def test_moments_stay_bit_equal_over_steps():
    """With the same gradients, m and v never depend on the parameters: four
    steps from zero keep every DFP-8 mantissa and exponent equal."""
    rng = np.random.default_rng(3)
    params, grads = _tree(rng)
    cfg = _cfg(8, 1e6)
    step = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, cfg))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_state(jp, cfg)
    tp = _port(params)
    ts = topt.init_state(tp, _tcfg(cfg))
    for i in range(4):
        g = jax.tree.map(lambda x: (x * rng.normal(1.0, 0.5, size=x.shape)).astype(np.float32), grads)
        jp, js, _ = step(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, _ = topt.apply_updates(tp, _port(g), ts, _tcfg(cfg))
        for key in ("m", "v"):
            want, got = _flat(jax.tree.map(np.asarray, js[key])), _flat(ts[key])
            for path, arr in want.items():
                assert np.array_equal(got[path], arr), (i, key, path)
        _check_params(jp, tp)


def test_row_chunks_change_nothing(monkeypatch):
    """Rows worked a few at a time (as the card's largest leaves are) give the
    whole leaf's update bit for bit.  (The clip is inactive: the global
    norm's float32 sum runs in chunk order.)"""
    rng = np.random.default_rng(4)
    params, grads = _tree(rng)
    out = []
    for chunk in (topt.CHUNK_ELEMS, 100):
        monkeypatch.setattr(topt, "CHUNK_ELEMS", chunk)
        tp = _port(params)
        cfg = _tcfg(_cfg(8, 1e6))
        ts = topt.init_state(tp, cfg)
        for _ in range(2):
            tp, ts, _ = topt.apply_updates(tp, _port(grads), ts, cfg)
        out.append((_flat(tp), _flat(ts["m"]), _flat(ts["v"])))
    for a, b in zip(out[0], out[1]):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_schedule_matches_reference():
    """The learning rate in the reference's compiled arithmetic: warmup,
    cosine decay, floor; at most one float32 ulp apart (a cos the two
    libraries round otherwise)."""
    for cfg in (jopt.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=20), jopt.OptConfig(lr=1e-4, warmup_steps=0,
                                                                                       decay_steps=60)):
        f = jax.jit(lambda s: jopt.schedule(cfg, s))
        for s in range(0, 80, 3):
            want = np.float32(f(jnp.int32(s)))
            got = np.float32(topt.schedule(_tcfg(cfg), torch.tensor(s, dtype=torch.int32)))
            assert abs(int(want.view(np.int32)) - int(got.view(np.int32))) <= 1, (cfg, s, want, got)


# -- the counterparts of the reference's optimizer tests --------------------------------------------------
def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = topt.OptConfig(lr=0.3, warmup_steps=0, decay_steps=10_000, weight_decay=0.0)
    state = topt.init_state(params, cfg)
    for _ in range(200):
        params, state, _ = topt.apply_updates(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_8bit_state_matches_fp32_convergence():
    """DFP-8 moments reach the same optimization quality: no blow-up, the same
    convergence."""
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    final = {}
    for bits in (32, 8):
        params = {"w": w0.clone()}
        cfg = topt.OptConfig(lr=0.05, warmup_steps=0, weight_decay=0.0, state_bits=bits)
        state = topt.init_state(params, cfg)
        for i in range(50):
            g = 2 * params["w"] + 0.01 * torch.sin(i + torch.arange(64.0))
            params, state, _ = topt.apply_updates(params, {"w": g}, state, cfg)
        final[bits] = params["w"].numpy()
    init_loss = float(np.sum(w0.numpy() ** 2))
    assert float(np.sum(final[32] ** 2)) < 0.05 * init_loss
    assert float(np.sum(final[8] ** 2)) < 0.10 * init_loss
    assert np.abs(final[8]).max() < 2 * np.abs(final[32]).max() + 1e-3


def test_8bit_v_sqrt_domain_no_explosion():
    """A row of wide dynamic range does not explode where v rounds to zero:
    the sqrt-domain encoding keeps m and sqrt(v) proportional."""
    params = {"w": torch.tensor([10.0] + [1e-3] * 63)}
    cfg = topt.OptConfig(lr=0.01, warmup_steps=0, weight_decay=0.0, state_bits=8)
    state = topt.init_state(params, cfg)
    for _ in range(20):
        params, state, _ = topt.apply_updates(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 20.0


def test_grad_clip_metric():
    params = {"w": torch.ones(4)}
    cfg = topt.OptConfig(grad_clip=1.0, warmup_steps=0)
    _, _, metrics = topt.apply_updates(params, {"w": torch.full((4,), 100.0)}, topt.init_state(params, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_scale_leaves_f32_moments_and_no_decay():
    """ttq_scales / inq_scales keep float32 moments under state_bits=8 and
    get no weight decay; inq_mask has no moments."""
    params = {"a": {"w": torch.ones(8, 4), "ttq_scales": torch.ones(2, 1, 4)},
              "b": {"w": torch.ones(8, 4), "inq_mask": torch.zeros(8, 4), "inq_scales": torch.ones(1, 4)}}
    cfg = topt.OptConfig(lr=0.5, warmup_steps=0, weight_decay=0.1, state_bits=8)
    state = topt.init_state(params, cfg)
    assert set(state["m"]["a"]["w"]) == {"q", "e"} and state["m"]["a"]["w"]["q"].dtype == torch.int8
    assert isinstance(state["m"]["a"]["ttq_scales"], torch.Tensor)
    assert state["m"]["a"]["ttq_scales"].dtype == torch.float32
    assert isinstance(state["m"]["b"]["inq_scales"], torch.Tensor)
    assert state["m"]["b"]["inq_mask"] is None
    zero = {k: {kk: torch.zeros_like(vv) for kk, vv in v.items()} for k, v in params.items()}
    new_p, _, _ = topt.apply_updates(params, zero, state, cfg)
    assert float((new_p["a"]["w"] - 1.0).abs().max()) > 0  # decay moved the weights
    assert torch.equal(new_p["a"]["ttq_scales"], torch.ones(2, 1, 4))
    assert torch.equal(new_p["b"]["inq_scales"], torch.ones(1, 4))
    assert torch.equal(new_p["b"]["inq_mask"], torch.zeros(8, 4))


@pytest.mark.parametrize("state_bits", [32, 8])
def test_inq_frozen_coords_pinned_through_updates(state_bits):
    """Frozen coordinates are bit-identical after a step with nonzero
    gradients and weight decay; the live ones and the grid move."""
    w = torch.randn(16, 4, generator=torch.Generator().manual_seed(0))
    mask = (w.abs() < 0.5).to(torch.float32)
    assert 0 < float(mask.sum()) < mask.numel()
    params = {"site": {"w": w.clone(), "inq_mask": mask, "inq_scales": torch.ones(2, 4)}}
    grads = {"site": {"w": torch.ones_like(w), "inq_mask": torch.zeros_like(mask),
                      "inq_scales": torch.full((2, 4), 0.1)}}
    cfg = topt.OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.1, state_bits=state_bits)
    new_p, _, _ = topt.apply_updates(params, grads, topt.init_state(params, cfg), cfg)
    frozen = mask > 0
    assert torch.equal(new_p["site"]["w"][frozen], w[frozen])
    assert bool((new_p["site"]["w"][~frozen] != w[~frozen]).all())
    assert bool((new_p["site"]["inq_scales"] != 1.0).all())
