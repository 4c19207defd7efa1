"""Row-sharded and batched flow across processes (``parallel/mesh.py::initialize_distributed``).

Gloo on the CPU, in two launches of spawned ranks (``tests/torch_multiprocess.py``),
each serving every check of its layout: 4 processes of one shard, and 2
processes of 2 shards (copies between a process's own shards and messages
between processes in one run).  In each, under the three PCG recurrences,
classic+nl-fast and hs through ``estimate_flow(mesh=flow_mesh())`` and the
HS level step from the unsharded level's result (where HS's global early
stop ends it) must be bit-identical to the one-process
mesh of the same 4 shards, with the same solve, iteration and
collective-round counts; and the batch over the processes
(``flow_mesh(batch=2)``: two rows of two pairs, the rows run by ranks 0 and
2 of 4, or 0 and 1 of 2) bit-identical to the one-process mesh's batch.
The test computes the one-process results, on one intra-op thread as the
ranks, while the ranks run.  Rendezvous by ``file://`` under the test's
temporary directory, so that parallel test workers do not race for ports.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_multiprocess as tm  # noqa: E402
from torch_parity import one_cpu_thread  # noqa: E402,F401

LAUNCHES = {"4x1": (4, 1), "2x2": (2, 2)}  # processes x shards a process


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{layout: (rank results, one-process results)}: both launches run while
    the test computes the one-process flows and the unmeshed batch."""
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    waits = {name: tm.spawn(world, per, tmp_path_factory.mktemp(name)) for name, (world, per) in LAUNCHES.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = tm.flows(flow_mesh(space=4, devices=["cpu"] * 4))
        ref["batch"] = estimate_flow_batched_rgb(*tm.frames()["batch"], "classic+nl-fast",
                                                 params={**tm.PARAMS, "dtype": torch.float64}, device="cpu").numpy()
        ref["batch_mesh"] = tm.flows(None, flow_mesh(batch=tm.BATCH_ROWS, devices=["cpu"] * 4))["batch"]
    finally:
        torch.set_num_threads(threads)
    return {name: (wait(), ref) for name, wait in waits.items()}


@pytest.mark.parametrize("layout", sorted(LAUNCHES))
def test_each_rank_holds_its_own_shards(runs, layout):
    world, per = LAUNCHES[layout]
    ranks, _ = runs[layout]
    assert [lay.index for lay, _ in ranks] == [tuple(range(r * per, (r + 1) * per)) for r in range(world)]
    assert all(lay.n == 4 and lay.owner == tuple(i // per for i in range(4)) for lay, _ in ranks)


@pytest.mark.parametrize("layout", sorted(LAUNCHES))
@pytest.mark.parametrize("method", ["classic+nl-fast", "hs"])
@pytest.mark.parametrize("algo", tm.ALGOS)
def test_sharded_flow_across_processes_is_bit_identical(runs, layout, method, algo):
    """Every rank's flow and counts equal the one-process mesh's; the flow
    recovers the 1 px shift, and at least one level ran sharded."""
    ranks, ref = runs[layout]
    uv_ref, *counts_ref = ref[method, algo]
    assert counts_ref[0] > 0
    for _, res in ranks:
        uv, *counts = res[method, algo]
        np.testing.assert_array_equal(uv, uv_ref)
        assert counts == counts_ref
    assert abs(uv_ref[8:-8, 8:-8, 0].mean() - 1.0) < 0.05


@pytest.mark.parametrize("layout", sorted(LAUNCHES))
@pytest.mark.parametrize("algo", tm.ALGOS)
def test_hs_global_stop_across_processes_is_bit_identical(runs, layout, algo):
    """The HS level ends at the same warp iteration in every process (its
    update's norm summed over every process's shards): started from its own
    converged result, the early stop ends it before its 10 warp iterations."""
    ranks, ref = runs[layout]
    uv_ref, warps_ref = ref["hs level", algo]
    assert 1 <= warps_ref < 10
    for _, res in ranks:
        uv, warps = res["hs level", algo]
        np.testing.assert_array_equal(uv, uv_ref)
        assert warps == warps_ref


@pytest.mark.parametrize("layout", sorted(LAUNCHES))
def test_psum_rounds_an_iteration_follow_the_recurrence(runs, layout):
    """3 psum rounds an iteration for classic, 1 for gear, 1 a 16-iteration
    block for cheby (beside its 25 Lanczos rounds a solve); one halo
    exchange an iteration for each."""
    _, res = runs[layout][0][0]
    for method in ("classic+nl-fast", "hs"):
        _, solves, iters, psums, halos = res[method, "classic"]
        assert psums == 3 * iters + 3 * solves and halos == iters + solves
        _, solves, iters, psums, halos = res[method, "gear"]
        assert psums == iters + 2 * solves and halos == iters + 3 * solves
        _, solves, iters, psums, halos = res[method, "cheby"]
        assert iters % 16 == 0 and psums == iters // 16 + 27 * solves and halos == iters + 14 * solves


@pytest.mark.parametrize("layout", sorted(LAUNCHES))
def test_batch_across_processes_is_bit_identical_to_the_unmeshed_batch(runs, layout):
    """Each rank gets every row's flows, bit for bit those of the one-process
    mesh of the same rows.  Against the unmeshed batch of 4 they agree within
    1e-12 on the CPU, where a vectorised op rounds a tensor's tail elements
    by the batch's size (ROADMAP's "CPU tails"); on the card, ``chip_smoke.py``
    phase 18 holds them to the unmeshed batch bit for bit."""
    ranks, ref = runs[layout]
    assert ref["batch"].shape == (tm.BATCH, 32, 48, 2)
    for _, res in ranks:
        np.testing.assert_array_equal(res["batch"], ref["batch_mesh"])
        np.testing.assert_allclose(res["batch"], ref["batch"], rtol=0, atol=1e-12)


def test_every_process_must_hold_a_shard_of_the_first_batch_row():
    """A row-sharded call on a mesh whose first batch row leaves a process out
    raises in every process alike (each sees it from the mesh's owners)."""
    from optical_flow_tpu_torch.parallel.mesh import FlowMesh, sharded_over

    cpus = (torch.device("cpu"),) * 4
    for rank in range(2):  # batch rows (rank 0, rank 0) and (rank 1, rank 1)
        with pytest.raises(ValueError, match="holds no shard of the mesh's first batch row"):
            with sharded_over(FlowMesh(cpus, 2, (0, 0, 1, 1), rank)):
                pass
    with sharded_over(FlowMesh(cpus, 2, (0, 1, 0, 1), 1)):  # the first row spans both processes
        pass


@pytest.mark.cuda
def test_two_cards_over_nccl_equal_the_one_process_mesh(tmp_path):
    """Two ranks, one card each, over NCCL (CUDA tensors moved directly):
    each rank's flow equals the one-process mesh of the two cards, bit for
    bit.  Needs two NVIDIA GPUs:
    ``python -m pytest tests/test_torch_multiprocess.py -m cuda --noconftest``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.parallel.launch import run_ranks
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    address = "file://" + str(tmp_path / "rendezvous")
    ranks = run_ranks(tm.rank_nccl_flow, 2, (address,), timeout=tm.SPAWN_TIMEOUT)
    rgb1, rgb2 = tm.frames()["classic+nl-fast"]
    ref = estimate_flow(rgb1, rgb2, "classic+nl-fast", tm.PARAMS,
                        mesh=flow_mesh(space=2, devices=["cuda:0", "cuda:1"])).cpu().numpy()
    for uv in ranks:
        np.testing.assert_array_equal(uv, ref)
