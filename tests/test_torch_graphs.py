"""CUDA graphs of the level step's plain-op chains (``utils/graphs.py``).

On the CPU: what a chain's graph is kept under, that CPU tensors and a
mesh's levels run every chain eagerly (and are counted so), the LRU over
call shapes, the arena's slots, and that the solve, the weighted median
and the median filter stay eager calls of the module attributes that the
benchmark wraps.  On the card (``cuda``): each chain's replay is its eager
run bit for bit at two shapes and sees a changed input, two calls return
flows that do not alias, the same four names are still called when every
chain replays, and a level that mixes graphs captured for two
configurations keeps its bits.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from optical_flow_tpu_torch import estimate_flow, load_of_method  # noqa: E402
from optical_flow_tpu_torch.methods import ba, base, classic_nl  # noqa: E402
from optical_flow_tpu_torch.ops.occlusion import detect_occlusion  # noqa: E402
from optical_flow_tpu_torch.utils import graphs  # noqa: E402

PARAMS = {"display": False, "max_iters": 2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def _frames(H=48, W=64):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return a, np.roll(a, 1, axis=1)


def _cfgs():
    """(Classic+NL-Fast's level config, BA's): Hermite bicubic and cubic B-spline warps."""
    nl = load_of_method("classic+nl-fast")
    nl.parse_input_parameter(PARAMS)
    b = load_of_method("ba")
    b.parse_input_parameter(PARAMS)
    return nl._nl_cfg(use_color=False).irls, b._level_cfg()


def _solves(method):
    """Solves a flow of 48x64 makes: levels x warps x linearisations, summed over the stages."""
    ope = load_of_method(method)
    ope.parse_input_parameter(PARAMS)
    if method == "classic+nl-fast":
        plan = ope._make_nl_plan((48, 64), use_color=True)
        stages = [(cfg.irls, a) for cfg, a in plan.stages]
    else:
        plan = ope._make_plan((48, 64))
        stages = list(plan.stages)
    levels = [plan.levels] + [plan.gnc_levels] * (len(stages) - 1)
    return sum(n * cfg.max_iters * cfg.max_linear for n, (cfg, _) in zip(levels, stages))


@pytest.fixture
def counted(monkeypatch):
    """Counts of the calls of the three module attributes that the benchmark's ranges wrap."""
    counts = {"solve": 0, "wmedian": 0, "median": 0}
    for name, mod, attr in (("solve", ba, "solve_flow_system"),
                            ("wmedian", classic_nl, "denoise_color_weighted_medfilt2"),
                            ("median", base, "median_filter2d")):
        def wrapped(*args, _fn=getattr(mod, attr), _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, attr, wrapped)
    return counts


def test_the_key_covers_chain_stage_level_shape_device_and_config():
    cfg, _ = _cfgs()
    uv = torch.zeros(24, 32, 2)
    images = torch.zeros(24, 32, 2)

    def key(chain="detect_occlusion", call=(1, 24, 32), stage=0, level=1, static=(cfg, 0.5), args=(uv, images)):
        with graphs.level(call, stage, level):
            return graphs.chain_key(chain, static, args)

    k = key()
    assert (k.chain, k.stage, k.level, k.B, k.H, k.W, k.device) == ("detect_occlusion", 0, 1, 1, 24, 32, "cpu")
    assert k == key(call=(1, 48, 64))  # the call shape picks the cache, not the key
    others = [
        key(chain="warp_deriv"),
        key(stage=1),
        key(level=0),
        key(args=(uv.expand(3, 24, 32, 2), images.expand(3, 24, 32, 2))),
        key(args=(torch.zeros(25, 32, 2), torch.zeros(25, 32, 2))),
        key(args=(torch.zeros(24, 33, 2), torch.zeros(24, 33, 2))),
        key(args=(uv.to("meta"), images.to("meta"))),
        key(static=(cfg, 0.0)),
        key(static=(dataclasses.replace(cfg, lambda_=2.0), 0.5)),
        key(args=(uv.double(), images.double())),
    ]
    fields = ["chain", "stage", "level", "B", "H", "W", "device", "config", "config", "config"]
    for other, field in zip(others, fields):
        assert getattr(other, field) != getattr(k, field)
    # the inputs' shapes are part of the config too; the rest of a key names one field each
    for other, field in [(others[i], fields[i]) for i in (0, 1, 2, 7, 8)]:
        assert [f for f in k._fields if getattr(other, f) != getattr(k, f)] == [field]
    with graphs.level(None, None, None):
        assert graphs.chain_key("detect_occlusion", (cfg, 0.5), (uv, images))[1:3] == (None, None)


@pytest.mark.parametrize("mesh", [False, True])
def test_cpu_tensors_and_mesh_levels_run_eagerly(mesh, monkeypatch):
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    flags = []
    graphable = graphs._graphable

    def recording(leaves, graphed):
        flags.append(graphed)
        return graphable(leaves, graphed)

    monkeypatch.setattr(graphs, "_graphable", recording)
    graphs.reset_stats()
    a, b = _frames()
    where = {"mesh": flow_mesh(space=8, devices=["cpu"] * 8)} if mesh else {"device": "cpu"}
    estimate_flow(a, b, "classic+nl-fast", {**PARAMS, "dtype": torch.float64}, **where)
    s = graphs.stats("cpu")
    assert s["captures"] == s["replays"] == 0 and s["eager"] == len(flags) > 0 and s["hit_share"] == 0.0
    assert graphs.stats() == s
    # a mesh runs its levels' chains eagerly wherever it runs them: 6-row shards fall back to the unsharded step
    assert set(flags) == ({False} if mesh else {True})
    graphs.reset_stats()
    assert graphs.stats() == {"captures": 0, "replays": 0, "eager": 0, "hit_share": None}


def test_the_lru_evicts_the_oldest_call_shape(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(graphs._state, "calls", type(graphs._state.calls)())
    dev = torch.device("cpu")
    shapes = [(1, 10 * k, 20) for k in range(1, graphs.MAX_CALL_SHAPES + 2)]
    groups = {}
    for call in shapes[:-1]:
        with graphs.level(call, 0, 0):
            groups[call] = graphs._group(dev)
    with graphs.level(shapes[0], 0, 0):
        assert graphs._group(dev) is groups[shapes[0]]  # used again: now the most recent
    with graphs.level(shapes[-1], 0, 0):
        graphs._group(dev)
    assert [call for _, call in graphs._state.calls] == shapes[2:-1] + [shapes[0], shapes[-1]]


def test_level_steps_share_the_arena_and_their_slots_do_not_overlap():
    group = graphs._Call(torch.device("cpu"))
    step_a, step_b = (0, 2, 1, 10, 12), (0, 1, 1, 20, 24)

    def span(t):
        start = t.data_ptr()
        return start, start + t.numel() * t.element_size()

    a = [group.slot(step_a, torch.empty(10, 12, 2)) for _ in range(3)]
    planar = torch.empty(3, 20, 24).movedim(0, -1)  # a flow as the resample leaves it: planes of components
    b = [group.slot(step_b, like) for like in (torch.empty(20, 24, 1), planar, torch.empty(20, 24, 3)[..., ::2])]
    for slots in (a, b):
        spans = sorted(span(t) for t in slots)
        assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))  # a step's slots are apart
        bases = [c.data_ptr() for c in group.chunks]
        assert all(any((s - base) % 512 == 0 <= s - base for base in bases) for s, _ in spans)
    assert span(a[0])[0] == span(b[0])[0]  # each level step starts at the arena's start
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in a + b[::2])  # dense or made so
    assert b[1].stride() == planar.stride() and b[2].shape == (20, 24, 2)
    assert {id(t) for t in a + b} <= group.static


@pytest.mark.parametrize("method, filt", [("classic+nl-fast", "wmedian"), ("classic++", "median")])
def test_the_kernel_calls_stay_eager_calls_of_the_module_attributes(method, filt, counted):
    a, b = _frames()
    estimate_flow(a, b, method, {**PARAMS, "dtype": torch.float64}, device="cpu")
    n = _solves(method)
    assert counted["solve"] == n and counted[filt] == n
    assert counted["median" if filt == "wmedian" else "wmedian"] == 0


def _chain_cases(cfg, device, B=None, H=24, W=32, seed=0):
    """(chain, fn, static, args) of one warp iteration of a level, on seeded inputs."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lead = () if B is None else (B,)

    def rand(*shape, scale=1.0):
        return (torch.rand(*lead, *shape, generator=g, dtype=torch.float64) * scale).to(torch.float32).to(device)

    images = rand(H, W, 2, scale=255.0)
    uv = rand(H, W, 2, scale=3.0) - 1.5
    duv = rand(H, W, 2) - 0.5
    pre = ba.warp_tables(cfg, images)
    It, Ix, Iy = ba.warp_derivatives(uv, pre)
    far = uv.clone()
    far[..., 3, 4, 0] = float("nan")
    return [("precompute_warp", ba.warp_tables, (cfg,), (images,)),
            ("warp_deriv", ba.warp_derivatives, (), (uv, pre)),
            ("blended_system", ba.irls_system, (cfg, 0.5), (uv, duv, It, Ix, Iy)),
            ("detect_occlusion", detect_occlusion, (), (uv + duv, images)),
            ("guard_level", ba.level_guard, (1e9,), (uv + duv, uv)),
            ("guard_level", ba.level_guard, (1e9,), (far, uv))]


def _leaves(x):
    out = []
    graphs._flatten(x, out)
    return [t.clone() for t in out]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B, H, W", [(None, 24, 32), (2, 40, 56)])
def test_each_chain_replays_its_eager_bits_and_sees_a_changed_input(cuda_device, B, H, W):
    graphs.reset_stats()
    for c, cfg in enumerate(_cfgs()):
        first = _chain_cases(cfg, cuda_device, B, H, W, seed=1)
        second = _chain_cases(cfg, cuda_device, B, H, W, seed=2)
        for k, ((chain, fn, static, args), (_, _, _, args2)) in enumerate(zip(first, second)):
            with graphs.level((B or 1, H, W), c, k):  # a key of its own for each case
                eager = _leaves(fn(*static, *args))
                captured = _leaves(graphs.run("test", chain, fn, static, *args))
                replayed = _leaves(graphs.run("test", chain, fn, static, *args))
                changed = _leaves(graphs.run("test", chain, fn, static, *args2))
            assert _equal(captured, eager) and _equal(replayed, eager), (cfg.interp, chain)
            assert _equal(changed, _leaves(fn(*static, *args2))), (cfg.interp, chain)
            assert not _equal(changed, eager), (cfg.interp, chain)
    s = graphs.stats(cuda_device)
    assert s["eager"] == 0 and s["captures"] == 12 and s["replays"] == 24


@pytest.mark.cuda
def test_two_calls_return_flows_that_do_not_alias(cuda_device):
    a, b = _frames()
    first = estimate_flow(a, b, "classic+nl-fast", {**PARAMS, "guard_flow": 1e9}, device="cuda")
    kept = first.clone()
    graphs.reset_stats()
    second = estimate_flow(b, a, "classic+nl-fast", {**PARAMS, "guard_flow": 1e9}, device="cuda")
    torch.cuda.synchronize()
    assert graphs.stats(cuda_device)["hit_share"] == 1.0
    assert first.data_ptr() != second.data_ptr() and torch.equal(first, kept)
    assert not torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("method, filt", [("classic+nl-fast", "wmedian"), ("classic++", "median")])
def test_the_kernel_calls_stay_eager_under_replay(cuda_device, method, filt, counted):
    a, b = _frames()
    first = estimate_flow(a, b, method, PARAMS, device="cuda")
    for k in counted:
        counted[k] = 0
    graphs.reset_stats()
    second = estimate_flow(a, b, method, PARAMS, device="cuda")
    s = graphs.stats(cuda_device)
    assert s["captures"] == s["eager"] == 0 and s["replays"] > 0
    n = _solves(method)
    assert counted["solve"] == n and counted[filt] == n
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_a_level_mixing_graphs_of_two_configurations_keeps_its_bits(cuda_device):
    """With the guard at 1e9 and without it, the chains but the guard share their graphs at each level;
    the flows of both, first and later calls, are one flow (the guard keeps a healthy flow)."""
    a, b = _frames(40, 56)
    flows = [estimate_flow(a, b, "classic+nl-fast", {**PARAMS, **extra}, device="cuda")
             for extra in ({"guard_flow": 1e9}, {}, {"guard_flow": 1e9}, {})]
    assert all(torch.equal(f, flows[0]) for f in flows[1:])
