"""
The port's optimizer transformations (megadetector_tpu_torch/training/
optim.py) against optax on the same float32 parameters and gradients, five
steps each: parameters and Adam moments within rtol 1e-6 (the chains the
JAX trainers and their tests build: clip_by_global_norm then adam or
adamw, and masked for the classification trainer's finetune mode).

The global norm is a float32 sum whose order differs (torch's against
XLA's vectorised reduce): it is held to optax.global_norm within rtol
1e-6 on its own. The chains are compared with the port's norm replaced by
optax's value on the same gradients, so that a one-ulp difference in the
norm does not reach the moments (an element of the first moment that
cancels to near zero would turn it into a large relative difference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from megadetector_tpu_torch.training import optim

RTOL = 1e-6
SHAPES = {'a': (3, 3, 4, 8), 'b': (8,), 'c': (16, 5), 'd': (5,)}
NAMES = sorted(SHAPES)


def _trees(seed, scale):
    rng = np.random.RandomState(seed)
    params = {k: rng.standard_normal(SHAPES[k]).astype(np.float32)
              for k in NAMES}
    grads = [{k: (rng.standard_normal(SHAPES[k]) * scale).astype(np.float32)
              for k in NAMES} for _ in range(5)]
    return params, grads


@pytest.fixture
def optax_norm(monkeypatch):
    """The port's global_norm replaced by optax's value."""

    def norm(grads):
        value = optax.global_norm([jnp.asarray(g.numpy()) for g in grads])
        return torch.tensor(np.asarray(value))

    monkeypatch.setattr(optim, 'global_norm', norm)


def _run_both(port_tx, optax_tx, seed=0, scale=1.0):
    params, grads = _trees(seed, scale)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    state_j = optax_tx.init(p_j)
    p_t = [torch.from_numpy(params[k].copy()) for k in NAMES]
    state_t = port_tx.init(p_t)
    for g in grads:
        g_j = {k: jnp.asarray(v) for k, v in g.items()}
        u_j, state_j = optax_tx.update(g_j, state_j, p_j)
        p_j = optax.apply_updates(p_j, u_j)
        u_t, state_t = port_tx.update(
            [torch.from_numpy(g[k]) for k in NAMES], state_t, p_t)
        optim.apply_updates(p_t, u_t)
    return p_j, state_j, p_t, state_t


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=0)


def _adam_state(state):
    for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s
    raise AssertionError('no Adam state')


@pytest.mark.parametrize('scale', [1.0, 0.01])
@pytest.mark.parametrize('kind', ['adam', 'adamw'])
def test_clipped_adam_and_adamw_match_optax(kind, scale, optax_norm):
    if kind == 'adam':
        port = optim.chain(optim.clip_by_global_norm(5.0), optim.adam(1e-3))
        ref = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    else:
        port = optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(1e-3, weight_decay=1e-5))
        ref = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adamw(1e-3, weight_decay=1e-5))
    p_j, state_j, p_t, state_t = _run_both(port, ref, scale=scale)
    adam_j = _adam_state(state_j)
    adam_t = state_t[1][0]
    assert adam_t['count'] == int(adam_j.count) == 5
    for i, k in enumerate(NAMES):
        _close(p_t[i], p_j[k])
        _close(adam_t['mu'][i], adam_j.mu[k])
        _close(adam_t['nu'][i], adam_j.nu[k])


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_global_norm_matches_optax(seed):
    _, grads = _trees(seed, 1.0)
    for g in grads:
        ref = optax.global_norm({k: jnp.asarray(v) for k, v in g.items()})
        ours = optim.global_norm([torch.from_numpy(g[k]) for k in NAMES])
        _close(ours, ref)


@pytest.mark.parametrize('max_norm', [0.5, 1e6])
def test_clip_by_global_norm_matches_optax(max_norm, optax_norm):
    _, grads = _trees(3, 1.0)
    g = grads[0]
    u_j, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in g.items()}, ())
    u_t, _ = optim.clip_by_global_norm(max_norm).update(
        [torch.from_numpy(g[k]) for k in NAMES], ())
    # optax's rule, not torch's clip_grad_norm_ (norm + 1e-6): with the
    # same norm, the clipped updates are equal
    for i, k in enumerate(NAMES):
        assert np.array_equal(u_t[i].numpy(), np.asarray(u_j[k]))
    if max_norm < 1:
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                           for v in g.values()))
        total = np.sqrt(sum(float((u.double() ** 2).sum()) for u in u_t))
        assert total == pytest.approx(max_norm, rel=1e-6)
        assert norm > max_norm


def test_masked_trains_the_mask_and_leaves_the_rest(optax_norm):
    mask = {'a': False, 'b': False, 'c': True, 'd': True}
    inner_j = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adamw(1e-3, weight_decay=1e-5))
    # the port's masked: frozen leaves get zero updates; as optax, that is
    # optax.masked plus set_to_zero on the complement
    ref = optax.chain(
        optax.masked(inner_j, mask),
        optax.masked(optax.set_to_zero(),
                     {k: not v for k, v in mask.items()}))
    port = optim.masked(
        optim.chain(optim.clip_by_global_norm(1.0),
                    optim.adamw(1e-3, weight_decay=1e-5)),
        [mask[k] for k in NAMES])
    params, _ = _trees(0, 1.0)
    p_j, state_j, p_t, state_t = _run_both(port, ref)
    adam_t = state_t[1][0]
    trained = [k for k in NAMES if mask[k]]
    assert len(adam_t['mu']) == len(trained)
    adam_j = _adam_state(state_j)
    for i, k in enumerate(NAMES):
        _close(p_t[i], p_j[k])
        if not mask[k]:
            assert np.array_equal(p_t[i].numpy(), params[k])
    for i, k in enumerate(trained):
        _close(adam_t['mu'][i], adam_j.mu[k])
        _close(adam_t['nu'][i], adam_j.nu[k])
    # optax.masked alone passes the frozen leaves' gradients through
    bare = optax.masked(inner_j, mask)
    p_b, _, _, _ = _run_both(port, bare)
    assert not np.array_equal(np.asarray(p_b['a']), params['a'])


def test_optimizer_steps_parameters_from_grad():
    params, grads = _trees(4, 1.0)
    ps = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
          for k in NAMES]
    opt = optim.Optimizer(ps, optim.chain(optim.clip_by_global_norm(5.0),
                                          optim.adam(1e-3)))
    tx = optim.chain(optim.clip_by_global_norm(5.0), optim.adam(1e-3))
    ref = [torch.from_numpy(params[k].copy()) for k in NAMES]
    state = tx.init(ref)
    for g in grads:
        opt.zero_grad()
        for p, k in zip(ps, NAMES):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        u, state = tx.update([torch.from_numpy(g[k]) for k in NAMES],
                             state, ref)
        optim.apply_updates(ref, u)
    for p, r in zip(ps, ref):
        assert torch.equal(p.detach(), r)


@pytest.mark.parametrize('kind', ['adam', 'adamw'])
def test_torch_optim_misses_the_optax_bar(kind):
    """Why training/optim.py exists: torch.optim.Adam / AdamW
    (foreach=False, fused=False), given optax's clipped gradients, end
    five steps further from optax than rtol 1e-6 (they fold the bias
    corrections into the step size and the denominator, lerp the first
    moment and decay the weights before the step), while the port's chain
    stays within it on the same trees."""
    params, grads = _trees(1, 1.0)
    max_norm = 5.0 if kind == 'adam' else 1.0
    if kind == 'adam':
        ref = optax.chain(optax.clip_by_global_norm(max_norm),
                          optax.adam(1e-3))
        port = optim.chain(optim.clip_by_global_norm(max_norm),
                           optim.adam(1e-3))
    else:
        ref = optax.chain(optax.clip_by_global_norm(max_norm),
                          optax.adamw(1e-3, weight_decay=1e-5))
        port = optim.chain(optim.clip_by_global_norm(max_norm),
                           optim.adamw(1e-3, weight_decay=1e-5))
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    state_j = ref.init(p_j)
    p_t = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
           for k in NAMES]
    p_o = [torch.from_numpy(params[k].copy()) for k in NAMES]
    state_o = port.init(p_o)
    make = torch.optim.Adam if kind == 'adam' else torch.optim.AdamW
    kwargs = {} if kind == 'adam' else {'weight_decay': 1e-5}
    opt = make(p_t, lr=1e-3, foreach=False, fused=False, **kwargs)
    for g in grads:
        g_j = {k: jnp.asarray(v) for k, v in g.items()}
        norm = torch.tensor(np.asarray(optax.global_norm(g_j)))
        u_j, state_j = ref.update(g_j, state_j, p_j)
        p_j = optax.apply_updates(p_j, u_j)
        for p, k in zip(p_t, NAMES):
            gk = torch.from_numpy(g[k].copy())
            p.grad = (gk / norm) * max_norm if bool(norm >= max_norm) \
                else gk
        opt.step()
        u_o, state_o = port.update(
            [torch.from_numpy(g[k]) for k in NAMES], state_o, p_o)
        optim.apply_updates(p_o, u_o)

    def worst(ps):
        return max(float(np.max(np.abs(p.detach().numpy() - np.asarray(
            p_j[k])) / np.abs(np.asarray(p_j[k])))) for p, k in zip(ps,
                                                                     NAMES))

    assert worst(p_o) <= RTOL
    assert worst(p_t) > 5 * RTOL
