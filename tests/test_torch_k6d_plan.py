"""K6d's layout (``ops/resident_pd.py::k6d_plan``): the grid, the rows a warp and a CTA own,
the route (each CTA's rows of Q or B held in shared memory, or read from the L2 every pass),
where x and the warps' partials of B'x live, the shared memory and the partials' scratch. The
CUDA launcher computes the same plan (``csrc/resident_dsvm.cuh``, ``pd_plan``); the card's tests
hold the two equal (tests/test_torch_cuda.py::test_k6d_plan_is_the_launchers)."""

import pytest

from adaprox_tpu_torch.ops import resident_pd as tp

SMS = [132, 114, 64, 7]
# (n, d, factored): the dual_svm driver's three shapes (heart_scale 384^2, svmguide3 1280^2,
# mushrooms' B 8192 x 128), ragged widths, the shared-memory thresholds and past them
SHAPES = [(384, 0, False), (1280, 0, False), (8192, 128, True), (270, 0, False),
          (1243, 0, False), (1283, 0, False), (8124, 112, True), (2112, 0, False),
          (2113, 0, False), (3397, 0, False), (3398, 0, False), (57856, 0, False),
          (57857, 0, False), (30000, 250, True), (600, 3500, True), (65536, 128, True),
          (1, 1, True), (1, 0, False), (17, 5, True)]
DRIVER = {(384, 0, False): 24, (1280, 0, False): 80, (8192, 128, True): 132}


def _ownership(n, plan):
    """The rows each CTA owns: warp w of CTA c takes rows c * 16 + w, + 16 * grid, ..."""
    nwarps = plan["grid"] * tp.K6D_WARPS
    owned = {}
    for c in range(plan["grid"]):
        for w in range(tp.K6D_WARPS):
            owned[(c, w)] = list(range(c * tp.K6D_WARPS + w, n, nwarps))
    return owned


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,d,factored", SHAPES)
def test_k6d_plan_owns_every_row_once_within_shared_memory(n, d, factored, itemsize, sms):
    plan = tp.k6d_plan(n, d, factored, itemsize, sms)
    assert set(plan) == set(tp.K6D_PLAN_KEYS)
    assert plan["grid"] == min(-(-n // tp.K6D_WARPS), sms)
    owned = _ownership(n, plan)
    rows = sorted(i for r in owned.values() for i in r)
    assert rows == list(range(n))  # every row once
    assert max(len(r) for r in owned.values()) == plan["rows_per_warp"]
    assert plan["rows_per_cta"] == tp.K6D_WARPS * plan["rows_per_warp"]
    # within a CTA's 227 KB, the kernel's static shared memory beside it
    assert 0 <= plan["smem_bytes"] <= tp.K6D_CTA_SMEM - tp.K6D_STATIC_SMEM
    length = d if factored else n
    held = plan["rows_per_cta"] * length * itemsize
    if plan["route"] == "shared":
        assert plan["x_shared"] and plan["acc_shared"] == factored
        assert plan["smem_bytes"] >= held + 4 * length
    else:
        assert plan["route"] == "l2" and plan["smem_bytes"] < held + 4 * length
    if factored:
        assert plan["x_shared"]  # B'x is always reduced into shared memory
    else:
        assert not plan["acc_shared"]
    # the partials: two halves of (4 + d) a CTA, the warps' B'x partials where off chip
    extra = 0 if plan["acc_shared"] or not factored else plan["grid"] * tp.K6D_WARPS * d
    assert plan["part_len"] == 2 * (tp.K6D_PARTS + (d if factored else 0)) * plan["grid"] + extra


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,d,factored", SHAPES)
def test_k6d_plan_follows_the_shape_and_the_sms_alone(n, d, factored, itemsize):
    """The plan is a function of (n, d, factored, itemsize, sms): asked twice it is the same;
    a card with enough SMs for every CTA gives the same plan as a larger one."""
    for sms in SMS:
        assert tp.k6d_plan(n, d, factored, itemsize, sms) == tp.k6d_plan(n, d, factored,
                                                                         itemsize, sms)
    need = -(-n // tp.K6D_WARPS)
    assert tp.k6d_plan(n, d, factored, itemsize, need) == tp.k6d_plan(n, d, factored,
                                                                      itemsize, need + 500)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", list(DRIVER))
def test_k6d_plan_holds_the_drivers_shapes_in_shared_memory(shape, itemsize):
    """heart_scale's 384^2, svmguide3's 1280^2 and mushrooms' 8192 x 128 (f32 and bf16) take
    the shared route on a 132-SM H100, at the grids of the cooperative kernel before (24, 80,
    132 CTAs): 16 rows a CTA dense, 64 factored."""
    n, d, factored = shape
    plan = tp.k6d_plan(n, d, factored, itemsize, 132)
    assert plan["route"] == "shared" and plan["grid"] == DRIVER[shape]
    assert plan["rows_per_cta"] == (64 if factored else 16)
    length = d if factored else n
    assert plan["smem_bytes"] >= plan["rows_per_cta"] * length * itemsize
    assert plan["smem_bytes"] <= {(384, 0, False): 27000, (1280, 0, False): 88000,
                                  (8192, 128, True): 49000}[shape]


@pytest.mark.parametrize("sms", [132, 64])
def test_k6d_plan_thresholds(sms):
    """The route changes where the held rows stop fitting: dense f32 at 16 rows a CTA up to
    2112 points on 132 SMs (then 32 rows a CTA, past 227 KB); bf16 up to 3397; x past
    57856 points is read from device memory; factored d past K6D_MAX_D is refused."""
    def route(n, d, factored, itemsize):
        return tp.k6d_plan(n, d, factored, itemsize, sms)["route"]

    if sms == 132:
        assert route(2112, 0, False, 4) == "shared" and route(2113, 0, False, 4) == "l2"
        assert route(3397, 0, False, 2) == "shared" and route(3398, 0, False, 2) == "l2"
    assert tp.k6d_plan(57856, 0, False, 4, sms)["x_shared"]
    assert not tp.k6d_plan(57857, 0, False, 4, sms)["x_shared"]
    assert tp.k6d_plan(57857, 0, False, 4, sms)["smem_bytes"] == 0
    assert route(65536, 128, True, 4) == "l2" and tp.k6d_plan(65536, 128, True, 4,
                                                             sms)["acc_shared"]
    assert not tp.k6d_plan(600, 3500, True, 4, sms)["acc_shared"]
    assert tp.k6d_plan(100, tp.K6D_MAX_D, True, 4, sms) is not None
    assert tp.k6d_plan(100, tp.K6D_MAX_D + 1, True, 4, sms) is None


def test_k6d_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((0, 0, False, 4, 132), (8, 0, True, 4, 132), (8, 8, True, 8, 132),
                (8, 0, False, 4, 0), (8, 0, False, 1, 132)):
        with pytest.raises(ValueError):
            tp.k6d_plan(*bad)
