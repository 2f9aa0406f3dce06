"""K4/K4b's plan (``ops/resident_bt.py::k4b_plan``): the lockstep groups, K2's grid, the rows a
warp owns, the route (each CTA forms a group's points in shared memory, or each dot forms them as
it goes), whether each CTA holds its rows of A in shared memory, the shared memory and the
scratch; and ``k4b_syncs``, the grid syncs a launch takes from its records, held
against a step-by-step walk of the lockstep phases over the plain version's records. The CUDA
launcher computes the same plan (``csrc/resident_bt.cu``, ``bt_plan``) and counts its syncs; the
card's tests hold both equal (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from adaprox_tpu_torch.ops import resident_bt as trb

SMS = [132, 7]
# (m, n): the drivers' shapes (the lasso 4000x1024, a5a / mushrooms / phishing's [X 1] padded,
# the cubic models 128^2), the sync floor 8x2176, a wide shape past the staged route at 8 rows,
# one past it at one row, and the smallest
SHAPES = [(4000, 1024), (6416, 128), (8128, 128), (11056, 128), (128, 128), (8, 2176),
          (64, 7008), (64, 7009), (4096, 56064), (4096, 56065), (1, 1)]
COUNTS = [1, 4, 8, 9, 17]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("m,n", SHAPES)
def test_k4b_plan_groups_grid_route_and_memory(m, n, count, itemsize, sms):
    plan = trb.k4b_plan(count, m, n, itemsize, sms)
    # the rows in table order, in groups of at most 8, only the last one short
    assert [j for grp in plan["groups"] for j in grp] == list(range(count))
    assert all(len(grp) == trb.K4B_GROUP for grp in plan["groups"][:-1])
    assert 1 <= len(plan["groups"][-1]) <= trb.K4B_GROUP
    assert plan["group"] == len(plan["groups"][0]) == min(count, trb.K4B_GROUP)
    # K2's grid: a warp a row of A (or A^T), at most one CTA an SM
    assert plan["grid"] == min(-(-max(m, n) // trb.K4B_WARPS), sms)
    # warp w of CTA c owns rows c 16 + w + k 16 grid: every row once, rows_per_warp at most
    nwarps = plan["grid"] * trb.K4B_WARPS
    owned = [list(range(w, m, nwarps)) for w in range(nwarps)]
    assert sorted(i for rows in owned for i in rows) == list(range(m))
    assert max(len(rows) for rows in owned) == plan["rows_per_warp"]
    # staged: the group's points in shared memory beside the static; else formed in the dot.
    # Held: the CTA's rows of A beside the points as well
    points = 4 * plan["group"] * n
    held = -(-(trb.K4B_WARPS * plan["rows_per_warp"] * n * itemsize) // 16) * 16
    budget = trb.K4B_CTA_SMEM - trb.K4B_STATIC_SMEM
    if plan["route"] == "staged":
        assert points <= budget
        assert plan["a_held"] == (held + points <= budget)
        assert plan["smem_bytes"] == points + (held if plan["a_held"] else 0) <= budget
    else:
        assert plan["route"] == "fly" and points > budget
        assert not plan["a_held"] and plan["smem_bytes"] == 0
    g = plan["group"]
    assert plan["scratch"] == dict(xs=(g, 2, n), gs=(g, 2, n), v=(g, n), res=(g, 2, m),
                                   part=g * trb.K4B_PARTS * sms)
    # the storage moves only whether A's rows fit, and so the shared memory
    other = trb.k4b_plan(count, m, n, 6 - itemsize, sms)
    assert {k: v for k, v in other.items() if k not in ("a_held", "smem_bytes")} == {
        k: v for k, v in plan.items() if k not in ("a_held", "smem_bytes")}
    if itemsize == 4 and plan["a_held"]:
        assert other["a_held"]


def test_k4b_plan_routes_at_the_thresholds():
    # 8 rows: 7008 columns staged (219 KB), 7009 on the fly; one row 56064 / 56065
    assert trb.k4b_plan(8, 64, 7008, 4, 132)["route"] == "staged"
    assert trb.k4b_plan(8, 64, 7009, 4, 132)["route"] == "fly"
    assert trb.k4b_plan(1, 64, 7009, 4, 132)["route"] == "staged"
    assert trb.k4b_plan(1, 64, 56064, 4, 132)["route"] == "staged"
    assert trb.k4b_plan(1, 64, 56065, 4, 132)["route"] == "fly"
    # the drivers' calls and K4's timed shapes: every one staged, A held
    for count, m, n in ((4, 4000, 1024), (4, 6416, 128), (4, 8128, 128), (4, 11056, 128),
                        (4, 128, 128), (2, 128, 128), (1, 4096, 1024), (1, 8, 2176)):
        plan = trb.k4b_plan(count, m, n, 4, 132)
        assert plan["route"] == "staged" and plan["a_held"]
    # 264x3072 f32: one row's point beside the CTA's 16 rows of A (192 KB), eight rows' not
    assert trb.k4b_plan(1, 264, 3072, 4, 132)["a_held"]
    assert not trb.k4b_plan(8, 264, 3072, 4, 132)["a_held"]
    assert trb.k4b_plan(8, 264, 3072, 2, 132)["a_held"]
    # 4096^2 f32: 32 rows of 16 KB a CTA, not held
    assert not trb.k4b_plan(1, 4096, 4096, 4, 132)["a_held"]


@pytest.mark.parametrize("args,match", [
    ((4, 16, 8, 8, 132), "float32 or bfloat16"), ((4, 16, 8, 1, 132), "float32 or bfloat16"),
    ((0, 16, 8, 4, 132), ">= 1"), ((4, 0, 8, 4, 132), ">= 1"), ((4, 16, 0, 4, 132), ">= 1"),
    ((4, 16, 8, 4, 0), ">= 1")])
def test_k4b_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        trb.k4b_plan(*args)


def _steps(numit, trials, nesterov, cubic=False):
    """A row's phases in order: "T" a trial; after each iteration it goes on from, "G" (PG:
    the gradient at z) or "M", "G" (Nesterov: the momentum point's forward pass, its
    gradient); "cubic" forms its gradient inside the next trial, so no "G"."""
    steps = []
    for i in range(numit):
        steps += ["T"] * int(trials[i])
        if i < numit - 1:
            steps += (["M"] if nesterov else []) + ([] if cubic else ["G"])
    return steps


def walk(groups, numits, trials, nesterovs, cubic=False):
    """The grid syncs of the lockstep kernel, phase by phase: a sync between two groups, two
    of warm-up for a group whose rows run, then one a phase while any row of the group has a
    step left, every such row taking its next step in it."""
    syncs = 0
    for k, grp in enumerate(groups):
        syncs += k > 0
        left = {j: _steps(int(numits[j]), trials[j], nesterovs[j], cubic) for j in grp}
        if any(int(numits[j]) > 0 for j in grp):
            syncs += 2
        while any(left.values()):
            for j in grp:
                if left[j]:
                    left[j].pop(0)
            syncs += 1
    return syncs


def _problem(m=40, n=16, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)) / np.sqrt(n)
    b = rng.standard_normal(m)
    gam = 1.0 / float(np.linalg.norm(a, 2) ** 2)
    return torch.as_tensor(a), torch.as_tensor(b), torch.zeros(n, dtype=torch.float64), gam


def _table(gam, count):
    """``count`` rows cycling over PG xi 1 / 1.5 / 2 and Nesterov, from gamma0 1x to 40x the
    stable step (the larger ones shrink: extra trials), so the rows stop at different
    iterations."""
    kinds = [(1.0, 0.0), (1.5, 0.0), (2.0, 0.0), (1.0, 1.0)]
    return [[gam * (1 + 3 * j), *kinds[j % 4]] for j in range(count)]


# (rows, tol, maxit, shrink): the drivers' four rows, tables of 1, 9 and 17, maxit 0 and 1,
# tol inf (no row runs), tol 0 (every row to maxit), the trial cap (shrink 1, 101 trials an
# iteration)
SWEEPS = [(4, 1e-4, 200, 0.5), (1, 1e-4, 200, 0.5), (9, 1e-4, 200, 0.5), (17, 1e-4, 60, 0.5),
          (4, 1e-6, 0, 0.5), (9, 1e-6, 1, 0.5), (4, float("inf"), 30, 0.5), (4, 0.0, 25, 0.5),
          (3, 0.0, 3, 1.0)]


def _cubic_problem(n=24, seed=4):
    """A cubic model: H = G'G / n + I / 2 (symmetric), q random, c 1; gamma0 1/||H||."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    h = g.T @ g / n + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    return (torch.as_tensor(h), torch.as_tensor(q), torch.zeros(n, dtype=torch.float64),
            1.0 / float(np.linalg.norm(h, 2)))


@pytest.mark.parametrize("obj", ["ls", "cubic"])
@pytest.mark.parametrize("count,tol,maxit,shrink", SWEEPS)
def test_k4b_syncs_follow_a_step_by_step_walk_of_the_records(count, tol, maxit, shrink, obj):
    cubic = obj == "cubic"
    a, b, x0, gam = _cubic_problem() if cubic else _problem()
    kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=1.0) if cubic else dict(p1=0.05)
    rows = _table(gam * (1e3 if shrink == 1.0 else 1.0), count)
    out = trb.resident_bt_sweep_plain(a, b, x0, rows, tol, maxit, shrink=shrink, **kw)
    numits = out[1].tolist()
    trials = out[5][3].tolist()
    nests = [r[2] > 0 for r in rows]
    plan = trb.k4b_plan(count, *a.shape, 4, 132)
    got = trb.k4b_syncs(plan["groups"], numits, trials, nests, cubic)
    assert got == walk(plan["groups"], numits, trials, nests, cubic)
    if maxit == 0 or tol == float("inf"):
        assert set(numits) == {0} and got == len(plan["groups"]) - 1
    else:
        assert min(numits) >= 1
    if shrink == 1.0:
        assert all(t == 101 for row in trials for t in row) and bool(out[4].all())
    if count in (4, 9) and tol == 1e-4 and maxit == 200:
        # the rows stop at different iterations, and some take extra trials
        assert len(set(numits)) > 1 and max(max(row) for row in trials) > 1
    # each group pays its longest row, not the sum over its rows
    for grp in plan["groups"]:
        chains = [len(_steps(numits[j], trials[j], nests[j], cubic)) for j in grp]
        assert max(chains) <= sum(chains)


def test_k4b_syncs_an_iteration():
    """One row: a PG iteration of one trial takes two syncs, each extra trial one, a Nesterov
    iteration three ("cubic", whose next trial forms the gradient: one and two); two of
    warm-up; none when no iteration runs."""
    for k in (1, 2, 5):
        assert trb.k4b_syncs([[0]], [k], [[1] * k], [False]) == 2 + k + (k - 1)
        assert trb.k4b_syncs([[0]], [k], [[1] * k], [True]) == 2 + k + 2 * (k - 1)
        assert trb.k4b_syncs([[0]], [k], [[3] * k], [False]) == 2 + 3 * k + (k - 1)
        assert trb.k4b_syncs([[0]], [k], [[1] * k], [False], cubic=True) == 2 + k
        assert trb.k4b_syncs([[0]], [k], [[1] * k], [True], cubic=True) == 2 + k + (k - 1)
        assert trb.k4b_syncs([[0]], [k], [[3] * k], [True], cubic=True) == 2 + 3 * k + (k - 1)
    assert trb.k4b_syncs([[0]], [0], [[]], [False]) == 0
    # two groups of rows: each its warm-up and longest row, one sync between them
    groups = [list(range(8)), [8]]
    numits = [3] * 8 + [5]
    trials = [[1, 1, 1]] * 7 + [[2, 1, 4]] + [[1] * 5]
    nests = [False] * 7 + [True] + [True]
    assert trb.k4b_syncs(groups, numits, trials, nests) == 1 + (2 + 7 + 4) + (2 + 5 + 8)
