"""The port's device scheduler (``repro_torch.core.device_sched``) against the
reference's, on the CPU.

The reference round runs in this process under ``jax.vmap`` with the worker
axis named, on the state with a local dimension of 1: every collective it uses
has a vmap rule, so no forced host devices are needed.  Its victim draws are
reproduced per worker from the state's keys, as ``jax.random.categorical``
makes them (the argmax of Gumbel noise plus the logits), and handed to the
port's round as ``gumbel``.  Integer fields must then be equal after every
round and float fields within a relative 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_sched as jds
from repro.core import steal
from repro_torch.core import device_sched as tds

FLOAT_RTOL = 1e-6
SPEEDS_16 = [24, 24, 16, 16, 8, 8, 4, 4, 2, 2, 1, 1, 1, 1, 1, 1]
CONFIGS = {  # P, speeds, tasks, radius, max_steal, rounds to completion
    "p8": (8, [24, 16, 8, 8, 4, 2, 1, 1], 192, 2, 8, 7),  # tests/test_device_sched.py
    "p16_r3": (16, SPEEDS_16, 480, 3, 4, 15),
    "p16_r0": (16, SPEEDS_16, 480, 0, 4, 30),  # no ring: no steals
}
P256_SPEEDS = [s for s in (24.0, 16.0, 4.0, 1.0) for _ in range(64)]  # scripts/sched_cell.py


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_windows(rng, batch, w):
    win_n = rng.integers(0, 40, (batch, w)).astype(np.float32)
    win_t = rng.uniform(0.05, 4.0, (batch, w)).astype(np.float32)
    win_t[rng.random((batch, w)) < 0.3] = np.nan  # cells not heard of yet
    win_t[:, w // 2] = rng.uniform(0.05, 4.0, batch)  # self is always known
    return win_n, win_t


@pytest.mark.parametrize("radius", [0, 1, 3, 51])
def test_steal_rate_window_matches_reference(radius):
    rng = np.random.default_rng(radius)
    win_n, win_t = _random_windows(rng, 500, 2 * radius + 1)
    want = np.asarray(jds.steal_rate_window(jnp.asarray(win_n), jnp.asarray(win_t), radius))
    got = tds.steal_rate_window(_t(win_n), _t(win_t), radius).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0)


def test_gamma_round_and_pair_rate_match_reference():
    rng = np.random.default_rng(7)
    n = 2000
    s = rng.uniform(0, 12, n).astype(np.float32)
    s[::7] = np.round(s[::7])  # integral rates: lo == hi
    s[3::11] = np.nan  # a rate read at an unknown cell
    n_i, n_j = (rng.integers(0, 40, n).astype(np.float32) for _ in range(2))
    t_i, t_j = (rng.uniform(0.05, 4.0, n).astype(np.float32) for _ in range(2))
    t_j[::5] = np.inf  # unknown peer, as the round passes it
    args = (s, n_i, t_i, n_j, t_j)
    want = np.asarray(jds.gamma_round(*map(jnp.asarray, args)))
    got = tds.gamma_round(*map(_t, args)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    pargs = (n_i, t_i, n_j, t_j)
    want = np.asarray(jds._pair_rate(*map(jnp.asarray, pargs)))
    got = tds._pair_rate(*map(_t, pargs)).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0, equal_nan=True)


def test_steal_rate_window_matches_host():
    """tests/test_device_sched.py's host check, through the port."""
    rng = np.random.default_rng(0)
    for _ in range(30):
        p, r = 9, 2
        n = rng.integers(0, 30, p).astype(float)
        t = rng.uniform(0.1, 5.0, p)
        for i in range(p):
            idx = steal.neighborhood(i, p, r)
            win_n = torch.tensor([n[j] for j in idx], dtype=torch.float32)
            win_t = torch.tensor([t[j] for j in idx], dtype=torch.float32)
            got = float(tds.steal_rate_window(win_n, win_t, r))
            want = steal.steal_rate_radius(i, n, t, r)
            assert got == pytest.approx(want, rel=2e-4, abs=2e-3)


def test_gamma_round_matches_host():
    rng = np.random.default_rng(1)
    for _ in range(60):
        s = rng.uniform(0, 10)
        n_i, n_j = rng.uniform(0, 20, 2)
        t_i, t_j = rng.uniform(0.1, 3.0, 2)
        got = int(tds.gamma_round(torch.tensor(s, dtype=torch.float32), n_i, t_i, n_j, t_j))
        want = steal.round_steal_rate(s, n_i, t_i, n_j, t_j)
        assert got == want, (s, n_i, t_i, n_j, t_j)


# ------------------------------------------------------------ round parity
def _counts(p, num_tasks):
    base, rem = divmod(num_tasks, p)
    return [base + (1 if i < rem else 0) for i in range(p)]


@functools.lru_cache(maxsize=None)
def _reference_round(p, radius, max_steal, packed):
    fn = functools.partial(jds.a2ws_round, axis="w", radius=radius, max_steal=max_steal,
                           num_workers=p, packed=packed)
    vround = jax.jit(jax.vmap(fn, axis_name="w"))

    def step(state):  # give every field a local dimension of 1, and take it off
        out = vround(jax.tree.map(lambda x: x[:, None], state))
        return jax.tree.map(lambda x: x[:, 0], out)

    return step


@functools.lru_cache(maxsize=None)
def _reference_draws(w):
    def one(key):
        _, sub = jax.random.split(jax.random.wrap_key_data(key))
        return jax.random.gumbel(sub, (w,), jnp.float32)

    return jax.jit(jax.vmap(one))


def _assert_same_state(jstate, tstate, rnd):
    for name in tds.SchedState._fields:
        want = np.asarray(getattr(jstate, name))
        got = getattr(tstate, name).numpy()
        assert got.dtype == want.dtype, (rnd, name, got.dtype, want.dtype)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0, equal_nan=True,
                                       err_msg=f"round {rnd}, field {name}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"round {rnd}, field {name}")


def _run_both(p, speeds, num_tasks, radius, max_steal, packed, max_rounds=4096):
    """Both schedulers round by round on the same draws; returns the port's
    final state, its rounds and its makespan."""
    counts = _counts(p, num_tasks)
    jstate = jds.init_state(p, jnp.asarray(counts, jnp.int32), jnp.asarray(speeds, jnp.float32),
                            radius, capacity=num_tasks)
    tstate = tds.init_state(p, counts, speeds, radius, num_tasks, device="cpu")
    _assert_same_state(jstate, tstate, 0)
    jround = _reference_round(p, radius, max_steal, packed)
    draws = _reference_draws(2 * radius + 1)
    tround = tds.make_round_fn(p, radius, max_steal, packed=packed, device="cpu")
    rounds = 0
    while int((tstate.tail - tstate.head).sum()) > 0 and rounds < max_rounds:
        gumbel = torch.from_numpy(np.array(draws(jstate.key)))
        jstate = jround(jstate)
        tstate = tround(tstate, gumbel=gumbel)
        rounds += 1
        _assert_same_state(jstate, tstate, rounds)
    return tstate, rounds, float(tstate.clock.max())


def _assert_conserved(state, num_tasks):
    ids = torch.cat([state.queue[i, : state.tail[i]] for i in range(state.queue.shape[0])])
    assert torch.equal(ids.sort().values, torch.arange(num_tasks, dtype=torch.int32))
    assert torch.equal(state.head, state.tail)
    assert int(state.executed.sum()) == num_tasks


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "baseline"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_round_by_round_parity(config, packed):
    p, speeds, num_tasks, radius, max_steal, want_rounds = CONFIGS[config]
    state, rounds, makespan = _run_both(p, speeds, num_tasks, radius, max_steal, packed)
    assert rounds == want_rounds
    _assert_conserved(state, num_tasks)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "baseline"])
def test_full_run_parity_p256(packed):
    """scripts/sched_cell.py's configuration: P=256, R=51, max_steal 16, 7680
    tasks, speeds {24, 16, 4, 1} in contiguous quarters."""
    state, rounds, makespan = _run_both(256, P256_SPEEDS, 7680, 51, 16, packed)
    assert rounds == 25
    assert makespan == 24.0
    _assert_conserved(state, 7680)


def test_full_run_parity_p1024():
    """Four times that configuration's workers (P=1024, R=204, 30 tasks each),
    packed: the u16 payload at a 30720-task capacity, window sums over 13
    windows of 32 and grants among 1024 peers, round by round.  The reference
    ends, as the port does, at the static partition's makespan: 30 tasks at
    speed 1."""
    speeds = [s for s in (24.0, 16.0, 4.0, 1.0) for _ in range(256)]
    state, rounds, makespan = _run_both(1024, speeds, 30720, 204, 16, packed=True)
    assert rounds == 30
    assert makespan == 30.0
    _assert_conserved(state, 30720)
    assert state.executed.view(4, 256).sum(1).tolist() == [8045, 7715, 7917, 7043]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "baseline"])
def test_own_generator_balances(packed):
    """The port's own draws at tests/test_device_sched.py's configuration."""
    state, rounds, makespan = tds.virtual_run(
        8, [24, 16, 8, 8, 4, 2, 1, 1], num_tasks=192, radius=2, max_steal=8,
        device="cpu", packed=packed, generator=torch.Generator().manual_seed(0),
    )
    _assert_conserved(state, 192)
    assert rounds < 4096
    assert state.executed[0] > state.executed[-1]
    assert makespan < 24.0 * 0.8  # the static partition: 24 tasks at speed 1


def test_seed_and_generator_agree():
    a = tds.virtual_run(16, SPEEDS_16, 480, 3, max_steal=4, seed=5, device="cpu")
    b = tds.virtual_run(16, SPEEDS_16, 480, 3, max_steal=4, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    assert a[1:] == b[1:]
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.virtual_run(8, [1.0] * 8, 16, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.make_round_fn(8, 1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.init_state(8, [2] * 8, [1.0] * 8, 1, 16)
    state = tds.init_state(8, [2] * 8, [1.0] * 8, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        tds.a2ws_round(state, radius=1, max_steal=4)
