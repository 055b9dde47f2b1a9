"""The port's mesh and multihost helpers (``parallel/mesh.py``,
``parallel/multihost.py``), as ``tests/test_parallel_utils.py`` and
``tests/multihost_worker.py`` hold the JAX package's: mesh sizes and the
"available" error, ``shard_batch`` placement (divisible leading axes
sliced per rank, odd and scalar entries replicated, values round-trip),
an all-reduce against the host sum, replicate, and the single-process and
two-rank ``host_info`` / ``local_batch_slice`` / ``main_process_only``,
with the idempotent second ``init_multihost``; without a card, a rank's
and a worker's default device (CUDA) raises. The two ranks are real
processes over gloo on the CPU (``parallel.launch.spawn``)."""

import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.parallel.multihost import (
    host_info as jax_host_info,
)
from lowlight_image_enhancement_tpu_torch.parallel import (
    all_reduce_mean_,
    create_mesh,
    replicate,
    shard_batch,
)
from lowlight_image_enhancement_tpu_torch.parallel.launch import (
    probe_helpers,
    spatial_run,
    spawn,
)
from lowlight_image_enhancement_tpu_torch.parallel.mesh import buckets
from lowlight_image_enhancement_tpu_torch.parallel.multihost import (
    host_info,
    init_multihost,
    local_batch_slice,
    main_process_only,
    rank_device,
)

CPUS = ["cpu"] * 8


def _batch(rng, n=8):
    return {"lq": rng.uniform(0, 1, (n, 3, 4, 4)).astype(np.float32),
            "expo_ratio": rng.uniform(1, 10, (n,)).astype(np.float32),
            "odd": rng.uniform(0, 1, (3, 2)).astype(np.float32),
            "scalar": np.float32(2.0), "pair_id": [f"p{i}" for i in range(n)]}


class TestMesh:
    def test_create_mesh_sizes(self):
        assert create_mesh(devices=CPUS).size == 8
        assert create_mesh(4, devices=CPUS).size == 4
        with pytest.raises(ValueError, match="available"):
            create_mesh(64, devices=CPUS)
        mesh = create_mesh(devices=CPUS)
        assert not mesh.distributed and mesh.axis_name == "data"

    def test_shard_batch_placement(self, rng):
        mesh = create_mesh(devices=CPUS)
        batch = _batch(rng)
        shards = shard_batch(batch, mesh)
        assert len(shards) == 8
        for i, sh in enumerate(shards):
            # divisible leading axes: this device's slice
            np.testing.assert_array_equal(sh["lq"].numpy(),
                                          batch["lq"][i:i + 1])
            assert sh["expo_ratio"].shape == (1,)
            # non-divisible and scalars: whole on every device
            np.testing.assert_array_equal(sh["odd"].numpy(), batch["odd"])
            assert sh["scalar"].shape == () and float(sh["scalar"]) == 2.0
            assert sh["pair_id"] == batch["pair_id"]
        # values survive the round trip
        np.testing.assert_array_equal(
            torch.cat([s["lq"] for s in shards]).numpy(), batch["lq"])

    def test_reductions_off_a_world_are_identity(self, rng):
        mesh = create_mesh(devices=CPUS[:1])
        t = [torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))]
        ref = t[0].clone()
        all_reduce_mean_(t, mesh)
        replicate(t, mesh)
        assert torch.equal(t[0], ref)

    def test_buckets_are_consecutive_and_capped(self):
        ts = [torch.zeros(n) for n in (10, 10, 30, 5, 100, 1)]
        groups = buckets(ts, cap=4 * 25)   # 25 fp32 elements a bucket
        assert [i for b in groups for i in b] == list(range(6))
        assert groups == [[0, 1], [2], [3], [4], [5]]


class TestMultihostHelpers:
    def test_host_info_single_process(self):
        assert host_info() == (0, 1, True) == tuple(jax_host_info())

    def test_local_batch_slice(self):
        assert local_batch_slice(16) == (16, 0)

    def test_main_process_only_runs(self):
        calls = []

        @main_process_only
        def record(v):
            calls.append(v)
            return v

        assert record(5) == 5
        assert calls == [5]

    def test_init_is_a_no_op_for_one_process(self, monkeypatch):
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(k, raising=False)
        init_multihost()
        init_multihost(num_processes=1)
        assert not torch.distributed.is_initialized()
        with pytest.raises(ValueError, match="coordinator"):
            init_multihost(num_processes=2, process_id=0)

    @pytest.mark.skipif(torch.cuda.is_available(),
                        reason="holds the defaults where CUDA is absent")
    def test_ranks_and_workers_default_to_cuda(self, tmp_path):
        """A rank owns ``cuda:LOCAL_RANK`` unless it is given the CPU: with
        no card, the defaults raise instead of moving to the CPU."""
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rank_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_multihost(f"file://{tmp_path / 'rendezvous'}", 2, 0)
        assert not torch.distributed.is_initialized()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spatial_run({})


@pytest.fixture(scope="module")
def two_ranks():
    batch = _batch(np.random.default_rng(0))
    return batch, spawn(probe_helpers, 2, device="cpu", args=(batch,),
                        threads=1)


class TestTwoRanks:
    def test_host_info_and_batch_slice(self, two_ranks):
        _, outs = two_ranks
        for r, out in enumerate(outs):
            assert out["host_info"] == (r, 2, r == 0)
            assert out["local_batch_slice"] == (4, 4 * r)
            assert out["mesh"] == (2, r, "cpu")

    def test_second_init_is_idempotent(self, two_ranks):
        _, outs = two_ranks
        assert all(out["same_group"] for out in outs)

    def test_main_process_only(self, two_ranks):
        _, outs = two_ranks
        assert outs[0]["main_only"] == ("ran", [1])
        assert outs[1]["main_only"] == (None, [])

    def test_shard_batch_per_rank(self, two_ranks):
        batch, outs = two_ranks
        for r, out in enumerate(outs):
            sh = out["shard"]
            np.testing.assert_array_equal(sh["lq"],
                                          batch["lq"][4 * r:4 * r + 4])
            np.testing.assert_array_equal(sh["odd"], batch["odd"])
            assert sh["scalar"].shape == () and float(sh["scalar"]) == 2.0
        np.testing.assert_array_equal(
            np.concatenate([o["shard"]["expo_ratio"] for o in outs]),
            batch["expo_ratio"])

    def test_all_reduce_equals_host_sum(self, two_ranks):
        _, outs = two_ranks
        for out in outs:
            np.testing.assert_array_equal(out["all_reduce"],
                                          np.full((3,), 1.0 + 2.0))

    def test_replicate_broadcasts_rank0(self, two_ranks):
        _, outs = two_ranks
        for out in outs:
            np.testing.assert_array_equal(out["replicate"], np.zeros((2, 2)))

    def test_collectives_counted_from_the_trace(self, two_ranks):
        """``compiled_collective_stats`` counts the all-reduce and the
        broadcast of ``replicate`` (its one fp32 buffer) that ran."""
        _, outs = two_ranks
        for out in outs:
            assert out["stats"] == {
                "all-reduce": {"count": 1, "bytes": 12,
                               "shapes": ["f32[3]"]},
                "broadcast": {"count": 1, "bytes": 16,
                              "shapes": ["f32[4]"]}}
