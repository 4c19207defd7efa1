"""The ranks of ``tests/test_torch_multiprocess.py`` (not a test module).

:func:`flows` computes every checked result on a mesh; a spawned rank
(:func:`rank_flows`) calls it on a mesh that spans the processes, the test
on the one-process mesh of the same shards, so the two run one code path.
:func:`spawn` launches the ranks over gloo on the CPU with a ``file://``
rendezvous and a time limit.  Nothing here imports JAX: the ranks stay
light.
"""
import os

import numpy as np

ALGOS = ("classic", "gear", "cheby")
H, W = 64, 48  # 16 rows a shard over 4: the finest levels tile (halo 8 at these warp counts)
PARAMS = {"display": False, "max_iters": 1, "max_warping_iters": 3, "solver": "pcg"}  # float64 added with torch
BATCH = 4  # RGB pairs of the meshed batch
BATCH_ROWS = 2  # its mesh's batch rows
SPAWN_TIMEOUT = 180.0  # seconds a launch may take before it fails (~20 s alone, more beside other test workers)


def _smooth(rng, shape, scale=255.0):
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(rng.uniform(0, 1, shape), sigma=1.5, mode="reflect")
    x = (x - x.min()) / max(np.ptp(x), 1e-9)
    return scale * x


def frames():
    """{name: (im1, im2)}: an RGB pair for classic+nl-fast and a gray pair for
    hs (each shifted 1 px right), the gray pair shifted with its edge column
    repeated for the HS level (whose update then falls below HS's stopping
    norm), and the (B, 32, 48, 3) RGB batch."""
    from scipy.ndimage import shift

    rng = np.random.default_rng(11)
    rgb = np.stack([_smooth(rng, (H, W)) for _ in range(3)], -1)
    gray = _smooth(rng, (H, W))
    batch = np.stack([np.stack([_smooth(rng, (32, 48)) for _ in range(3)], -1) for _ in range(BATCH)])
    return {"classic+nl-fast": (rgb, np.roll(rgb, 1, axis=1)), "hs": (gray, np.roll(gray, 1, axis=1)),
            "hs level": (gray, shift(gray, (0, 1.0), mode="nearest")), "batch": (batch, np.roll(batch, 1, axis=2))}


def _counts():
    from optical_flow_tpu_torch.parallel import dist

    return dist.solves, dist.iterations, dist.psum_rounds, dist.halo_rounds


def flows(mesh, batch_mesh=None) -> dict:
    """Under each recurrence (with ``mesh``): ``(method, algo)`` ->
    (flow, solves, iterations, psum rounds, halo rounds) of
    ``estimate_flow(mesh=mesh)`` for classic+nl-fast and hs, and
    ``("hs level", algo)`` -> (the level, its warp iterations) of
    ``hs_level_step_spatial`` from the unsharded level's own result, where
    HS's early stop ends it; with ``batch_mesh``, ``"batch"`` ->
    ``estimate_flow_batched_rgb`` over it."""
    import torch

    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.methods.hs import hs_level_step
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb
    from optical_flow_tpu_torch.parallel.spatial import hs_level_step_spatial
    from optical_flow_tpu_torch.solvers import cg

    params = {**PARAMS, "dtype": torch.float64}
    data = frames()
    out = {}
    if mesh is not None:
        ope = load_of_method("hs")
        ope.parse_input_parameter({"display": False, "solver": "pcg", "dtype": torch.float64})
        hs_cfg = ope._level_cfg()
        images = torch.as_tensor(np.stack(data["hs level"], -1))
        start = hs_level_step(hs_cfg, images, torch.zeros((H, W, 2), dtype=torch.float64))  # unsharded: no collective
    for algo in ALGOS if mesh is not None else ():
        cg.CG_ALGO = algo
        try:
            for method in ("classic+nl-fast", "hs"):
                dist.reset_counts()
                uv = estimate_flow(*data[method], method, params, mesh=mesh).numpy()
                out[method, algo] = (uv, *_counts())
            dist.reset_counts()
            out["hs level", algo] = (hs_level_step_spatial(hs_cfg, images, start, mesh, 6).numpy(), dist.solves)
        finally:
            cg.CG_ALGO = "classic"
    if batch_mesh is not None:
        out["batch"] = estimate_flow_batched_rgb(*data["batch"], "classic+nl-fast", mesh=batch_mesh,
                                                 params=params).numpy()
    return out


def rank_flows(rank, world_size, address, shards_per_rank):
    """One rank: join the run with ``shards_per_rank`` CPU devices, and return
    (the mesh's layout, :func:`flows` on ``flow_mesh()`` and, over
    ``flow_mesh(batch=2)``, the batch: two rows of two pairs, each row run by
    the process of its first device, the other processes idle)."""
    import torch

    from optical_flow_tpu_torch.parallel.mesh import flow_mesh, initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(address, world_size, rank, "gloo", device=["cpu"] * shards_per_rank,
                           timeout=SPAWN_TIMEOUT)
    mesh = flow_mesh()
    return mesh.space_layout(), flows(mesh, flow_mesh(batch=BATCH_ROWS))


def spawn(world_size, shards_per_rank, rendezvous_dir):
    """Start the ranks; returns a function that waits for their results (in
    rank order) and raises if a rank failed or the launch outlived
    :data:`SPAWN_TIMEOUT`."""
    import threading

    from optical_flow_tpu_torch.parallel.launch import run_ranks

    address = "file://" + os.path.join(str(rendezvous_dir), "rendezvous")
    box = {}

    def run():
        try:
            box["results"] = run_ranks(rank_flows, world_size, (address, shards_per_rank), timeout=SPAWN_TIMEOUT)
        except BaseException as e:  # re-raised by wait()
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join(SPAWN_TIMEOUT + 30.0)  # run_ranks stops the ranks at SPAWN_TIMEOUT
        assert not thread.is_alive(), "the launch outlived its time limit"
        if "error" in box:
            raise box["error"]
        return box["results"]

    return wait


def rank_nccl_flow(rank, world_size, address):
    """One rank of the two-card NCCL run: card ``rank``, classic+nl-fast in
    float32 over ``flow_mesh()`` (one shard a card); returns the flow."""
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh, initialize_distributed

    initialize_distributed(address, world_size, rank, "nccl", timeout=SPAWN_TIMEOUT)
    rgb1, rgb2 = frames()["classic+nl-fast"]
    return estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, mesh=flow_mesh()).cpu().numpy()
