"""The fused kernels' tile plan (``repro_torch.kernels.fused_mlp.tile_plan``).

* the store's shape (``PAPER_STORE``) takes the full tile with the heads
  together;
* wider hidden layers step down to the mid and narrow tiles, each plan
  stages the deepest weight slab that fits, and the widest model the
  previous kernel took still gets a plan;
* a model past every tile raises ``ValueError`` naming each candidate's
  shared-memory bytes, before anything is built or launched;
* every plan's schedule, run group by group and pass by pass with plain
  PyTorch ops over activation buffers filled with NaN, gives the logits
  of ``ref._forward_flat``: no group reads a row it was not given, and no
  write lands on a row that is still to be read.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.model import MLPSpec, init_params
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import ops, ref


def _spec(width, shared, private, cards):
    tasks = [f"t{i}" for i in range(len(cards))]
    priv = {t: tuple(private[i]) for i, t in enumerate(tasks)}
    return MLPSpec(10, width, tuple(shared), priv, dict(zip(tasks, cards)))


STORE = _spec(8, (256, 256), [(64,)] * 4, (1000, 5, 3, 1))


def test_store_shape_takes_the_full_tile():
    plan = fm.tile_plan(STORE)
    assert plan.tile.name == "full" and plan.schedule == "heads together"
    assert plan.smem_bytes <= fm.SMEM_LIMIT
    # gather, dense, the four 64-wide first layers as one 256-column
    # pass, then every out layer in one group of 1,016 columns
    assert plan.groups[:, 1].tolist() == [1, 1, 4, 4]
    assert plan.groups[:, 2].tolist() == [256, 256, 256, 1016]
    assert plan.cap == 256


@pytest.mark.parametrize("shared,private,tile", [
    ((256, 256), (64,), "full"),
    ((256,), (256, 256), "mid"),
    ((300, 300), (64,), "mid"),
    ((590,), (590,), "mid"),
    ((1024,), (64,), "mid"),
    ((800,), (800, 800), "narrow"),
    ((2048,), (64,), "narrow"),
    ((2400,), (2400, 2400), "narrow"),
])
def test_wider_layers_step_down(shared, private, tile):
    spec = _spec(8, shared, [private] * 2, (7, 3))
    plan = fm.tile_plan(spec)
    assert plan.tile.name == tile
    assert plan.smem_bytes <= fm.SMEM_LIMIT
    # the wider tiles were refused for their shared memory
    for cand in fm._candidate_plans(spec):
        if cand.tile.rows > plan.tile.rows:
            assert cand.smem_bytes > fm.SMEM_LIMIT


@pytest.mark.parametrize("shared,private,tile,slab", [
    ((256, 256), (64,), "full", 32),
    ((512, 512), (64,), "mid", 32),
    ((590, 590), (64,), "mid", 16),
    ((1024, 1024), (64,), "narrow", 8),
    ((2000, 2000), (64,), "narrow", 8),
    ((2400,), (2400, 2400), "narrow", 0),
])
def test_plan_takes_the_first_slab_that_fits(shared, private, tile, slab):
    spec = _spec(8, shared, [private] * 4, (1000, 5, 3, 1))
    plan = fm.tile_plan(spec)
    assert (plan.tile.name, plan.slab) == (tile, slab)
    assert plan.smem_bytes <= fm.SMEM_LIMIT
    for cand in fm._candidate_plans(spec):
        if (cand.tile, cand.schedule, cand.slab) == (plan.tile, plan.schedule, plan.slab):
            break
        assert cand.smem_bytes > fm.SMEM_LIMIT
    assert plan.smem_bytes == 4 * fm._smem_words(plan.tile, plan.cap, slab, 8, 4)


def test_widest_model_of_the_kernel_limits_gets_a_plan():
    """Hidden widths 2,400, 64 layers and 32 heads (ROADMAP's kernel
    limits; predicate tables do not enter the plan)."""
    private = [(2400,)] * 16 + [()] * 16
    spec = _spec(8, (2400,) * 16, private, (7,) * 32)
    assert len(spec.shared) + sum(len(p) + 1 for _, p in spec.private) == fm.MAX_LAYERS
    plan = fm.tile_plan(spec)
    assert plan.tile.name == "narrow" and plan.smem_bytes <= fm.SMEM_LIMIT


def test_past_every_tile_raises_with_byte_counts():
    spec = _spec(8, (4096,), [(4096, 4096)] * 2, (7, 3))
    with pytest.raises(ValueError) as e:
        fm.tile_plan(spec)
    for cand in fm._candidate_plans(spec):
        want = f"{cand.tile.name} {cand.schedule} slab {cand.slab}: {cand.smem_bytes} B"
        assert want in str(e.value)


def test_too_many_layers_raise():
    with pytest.raises(ValueError, match="at most"):
        fm.tile_plan(_spec(8, (16,) * 65, [()], (3,)))


def test_plan_is_computed_once_per_spec():
    assert fm.tile_plan(STORE) is fm.tile_plan(_spec(8, (256, 256), [(64,)] * 4, (1000, 5, 3, 1)))


def test_refused_plan_hint_names_the_plan():
    class Lib:
        @staticmethod
        def repro_error_string(err):
            return b"invalid argument"

    plan = fm.tile_plan(STORE)
    with pytest.raises(RuntimeError) as e:
        fm._raise_on(fm._CUDA_ERROR_INVALID_VALUE, Lib, "fused_mlp", plan)
    assert "256 activation rows" in str(e.value) and str(plan.smem_bytes) in str(e.value)


def _run_schedule(plan, flat, spec, digits):
    """The plan's schedule with plain ops: pass by pass, each pass reading
    the buffer as it stands and then writing its columns, as the kernel
    does.  Unwritten rows are NaN and ReLU keeps NaN, so a wrong read
    shows in the logits."""
    n = digits.shape[0]
    buf = torch.full((plan.cap + 1, n), float("nan"))
    buf[plan.cap] = 0.0
    logits = {}
    step = plan.tile.pass_cols
    for first, count, cols, out in plan.groups.tolist():
        members = plan.members[first:first + count].tolist()
        for p0 in range(0, cols, step):
            writes = []
            for layer, head, col, src, dst in members:
                w, b = flat[2 * layer], flat[2 * layer + 1]
                fan_in, fan_out = _layer_dims(spec)[layer]
                span = -(-fan_out // 4) * 4  # a member's columns, padded to 4
                lo, hi = max(col, p0), min(col + span, p0 + step)
                if lo >= hi:
                    continue
                if src < 0:
                    y = ref._gather(w, b, digits)
                else:
                    x = torch.zeros((n, w.shape[0]))
                    x[:, :fan_in] = buf[src:src + fan_in].T
                    y = x @ w + b
                if out:
                    lg = logits.setdefault(head, torch.full((n, w.shape[-1]), float("nan")))
                    j = slice(lo - col, min(hi - col, fan_out))
                    lg[:, j] = y[:, j]
                else:
                    for c in range(lo - col, min(hi - col, fan_out)):
                        writes.append((dst + c, torch.relu(y[:, c])))
            for row, v in writes:
                buf[row] = v
    return [logits[h] for h in range(len(spec.tasks))]


def _layer_dims(spec):
    dims, d = [], None
    for h in spec.shared:
        dims.append((d, h))
        d = h
    for t in spec.tasks:
        hd = d
        for h in (*spec.private_map[t], spec.card_map[t]):
            dims.append((hd, h))
            hd = h
    return dims


SCHEDULE_SPECS = {
    "store": STORE,
    "no trunk": _spec(6, (), [(64,), (), (32, 16)], (7, 3, 130)),
    "private depth 2": _spec(8, (256, 256), [(64, 64)] * 4, (1000, 5, 3, 1)),
    "hidden 1024": _spec(8, (1024,), [(64,)] * 2, (300, 5)),
    "card 1100": _spec(8, (256,), [(64,)] * 2, (1100, 2)),
    "uneven heads": _spec(5, (96, 40), [(24, 8), (), (60,)], (9, 2, 33)),
    # hidden groups of more than one pass, which must not write over
    # their inputs: six 44-wide heads (264 columns) on the full tile, and
    # a 1,100-wide dense layer on the narrow tile
    "six heads": _spec(8, (32,), [(44,)] * 6, (5,) * 6),
    "dense 1100": _spec(4, (1100, 1100), [(16,)], (6,)),
}
def _first_fit_per_schedule(spec):
    """(index, plan) of the first fitting candidate of each (tile,
    schedule): the slab depth leaves the schedule as it is."""
    seen = set()
    for i, p in enumerate(fm._candidate_plans(spec)):
        if p.smem_bytes <= fm.SMEM_LIMIT and (p.tile.name, p.schedule) not in seen:
            seen.add((p.tile.name, p.schedule))
            yield i, p


PLAN_CASES = [
    pytest.param(name, i, id=f"{name}-{p.tile.name}-{p.schedule.replace(' ', '_')}")
    for name, spec in SCHEDULE_SPECS.items()
    for i, p in _first_fit_per_schedule(spec)
]


@pytest.mark.parametrize("name,index", PLAN_CASES)
def test_schedule_equals_the_plain_forward(name, index):
    spec = SCHEDULE_SPECS[name]
    plan = list(fm._candidate_plans(spec))[index]
    params = init_params(spec, seed=7, device="cpu")
    flat, _ = ops.pad_flat_weights(params, spec)
    digits = torch.from_numpy(
        np.random.default_rng(7).integers(0, spec.base, (37, spec.width)).astype(np.int32))
    got = _run_schedule(plan, flat, spec, digits)
    want = ref._forward_flat(flat, spec, digits, emit_codes=False)
    for t, g, w in zip(spec.tasks, got, want):
        card = spec.card_map[t]
        assert not torch.isnan(g[:, :card]).any(), f"{t}: a group read an unwritten row"
        torch.testing.assert_close(g[:, :card], w[:, :card], rtol=1e-6, atol=1e-6)
    # every layer in exactly one group, every head's out layer in an out group
    assert sorted(plan.members[:, 0].tolist()) == list(range(len(plan.members)))
    outs = [m for g in plan.groups if g[3] for m in plan.members[g[0]:g[0] + g[1]]]
    assert sorted(int(m[1]) for m in outs) == list(range(len(spec.tasks)))
