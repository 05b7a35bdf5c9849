"""The port's pair sharding (allwave_tpu_torch/parallel) against
tests/test_parallel.py and tests/test_multihost.py: the four tests of
the first with `parallel.mesh.local_devices` patched to return eight
CPU devices (the analog of conftest's eight virtual JAX CPU devices),
the port's sharded step against the reference's on its 8-device mesh,
and two processes joined by a gloo process group whose merged PAF
shards equal a single-process run."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from allwave_tpu_torch.core.scores import parse_scores
from allwave_tpu_torch.parallel import mesh
from allwave_tpu_torch.wfa import dense as D_
from allwave_tpu_torch.wfa.params import resolve_penalties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


def _pool_batch(rng, n_seqs, L, l_pad, n_pairs):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = np.zeros((n_seqs, l_pad), np.uint8)
    lens = np.zeros(n_seqs, np.int32)
    for i in range(n_seqs):
        s = rng.choice(bases, L)
        if i:
            mut = rng.rand(L) < 0.05
            s = pool[0, :L].copy()
            s[mut] = rng.choice(bases, mut.sum())
        pool[i, :L] = s
        lens[i] = L
    qidx = rng.randint(0, n_seqs, n_pairs).astype(np.int32)
    tidx = rng.randint(0, n_seqs, n_pairs).astype(np.int32)
    return pool, qidx, tidx, lens[qidx], lens[tidx]


def _port_sharded_and_single(n_pairs):
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    rng = np.random.RandomState(3)
    l_pad, K, run_cap = 128, 128, 64
    arrays = _pool_batch(rng, 6, 100, l_pad, n_pairs)
    pool, qidx, tidx, qlens, tlens = (torch.from_numpy(a) for a in arrays)
    qidx, tidx = qidx.long(), tidx.long()
    step = mesh.sharded_dense_step(CPU8, pen, K, l_pad, run_cap)
    sharded = step(pool, qidx, tidx, qlens, tlens).numpy()
    single = D_.dense_align_packed(
        pool, qidx, tidx, qlens, tlens, pen, K, l_pad, run_cap
    ).numpy()
    return arrays, sharded, single


@pytest.mark.parametrize("n_pairs", [16, 13], ids=["even", "uneven"])
def test_sharded_dense_step_matches_single_device(n_pairs):
    _, sharded, single = _port_sharded_and_single(n_pairs)
    assert sharded.shape[0] == n_pairs
    np.testing.assert_array_equal(sharded, single)


def test_check_entry_point_helpers_on_cpu_devices():
    """parallel.check's helpers (the multi-GPU check and smoke phase 19)
    on three CPU devices: a split with a remainder."""
    from allwave_tpu_torch.core.types import Sequence
    from allwave_tpu_torch.parallel import check

    rng = np.random.RandomState(9)
    seqs = [Sequence(f"s{i}", rng.choice(list(b"ACGT"), 90).astype(np.uint8).tobytes())
            for i in range(5)]
    inputs = check.dispatch_inputs(seqs, torch.device("cpu"), 13, l_pad=128)
    assert inputs[1].shape[0] == 13
    assert check.sharded_matches_single(CPU8[:3], inputs, K=128, l_pad=128, cap=64)


def test_sharded_dense_step_matches_the_reference_mesh():
    """The same inputs through the reference's shard_map step on its
    8-device CPU mesh give the same bytes."""
    import jax
    import jax.numpy as jnp

    from allwave_tpu.core.scores import parse_scores as ref_scores
    from allwave_tpu.parallel.mesh import make_mesh, sharded_dense_step
    from allwave_tpu.wfa.params import resolve_penalties as ref_pen

    (pool, qidx, tidx, qlens, tlens), sharded, _ = _port_sharded_and_single(16)
    assert jax.local_device_count() >= 8
    m = make_mesh(8, diag=1)
    step = sharded_dense_step(
        m, ref_pen(ref_scores("0,5,8,2,24,1")), 128, 128, 64, impl="xla"
    )
    with m:
        ref = np.asarray(step(*(jnp.asarray(a) for a in (pool, qidx, tidx, qlens, tlens))))
    np.testing.assert_array_equal(sharded, ref)


def test_shard_pairs_partition_is_exact():
    from allwave_tpu_torch.parallel.dist import shard_pairs

    pairs = np.arange(46).reshape(23, 2)
    shards = [shard_pairs(pairs, p, 4) for p in range(4)]
    got = np.concatenate(shards, axis=0)
    assert sorted(map(tuple, got.tolist())) == sorted(
        map(tuple, pairs.tolist())
    )


def test_distributed_aligner_single_process_covers_all(tmp_path):
    from allwave_tpu_torch.core.types import NoSparsification, Sequence
    from allwave_tpu_torch.parallel.dist import (
        DistributedAllPairAligner,
        merge_paf_shards,
    )

    rng = np.random.RandomState(4)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = []
    for i in range(5):
        s = rng.choice(bases, 120)
        seqs.append(Sequence(f"s{i}", s.tobytes()))
    al = DistributedAllPairAligner(
        seqs,
        parse_scores("0,5,8,2,24,1"),
        sparsification=NoSparsification(),
    )
    assert al.pair_count() == 20  # single process owns everything
    prefix = str(tmp_path / "out")
    al.run_to_paf_shard(prefix)
    merged = str(tmp_path / "merged.paf")
    merge_paf_shards(prefix, 1, merged)
    lines = open(merged).read().strip().splitlines()
    assert len(lines) == 20


def test_production_pipeline_uses_local_mesh_byte_identical(monkeypatch):
    """With more than one local device the production pipeline fans
    dispatch groups over them via sharded_dense_step; the PAF output
    must be byte-identical to the single-device path."""
    from allwave_tpu_torch.core.paf import alignment_to_paf
    from allwave_tpu_torch.core.types import NoSparsification
    from allwave_tpu_torch.engine.pipeline import AllPairAligner
    from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case
    from allwave_tpu_torch.wfa import dense_engine as DE

    monkeypatch.setattr(mesh, "local_devices", lambda device: CPU8)
    cfg = MutationConfig(snp_rate=0.05, insertion_rate=0.002, deletion_rate=0.002)
    case = make_test_case(seed=77, n_sequences=7, length=150, cfg=cfg)
    params = parse_scores("0,5,8,2,24,1")

    def run():
        al = AllPairAligner(
            case.sequences,
            params,
            exclude_self=True,
            use_mash_orientation=True,
            sparsification=NoSparsification(),
        )
        out = []
        al.for_each_with_callback(out.append)
        return sorted(alignment_to_paf(r, case.sequences) for r in out)

    calls = {"mesh": 0}
    orig = DE.DenseBandAligner._sharded_fn

    def counting(self, *a, **k):
        calls["mesh"] += 1
        return orig(self, *a, **k)

    monkeypatch.setattr(DE.DenseBandAligner, "_sharded_fn", counting)
    meshed = run()
    assert calls["mesh"] > 0, "mesh path not exercised"

    monkeypatch.setenv("ALLWAVE_SINGLE_DEVICE", "1")
    calls["mesh"] = 0
    single = run()
    assert calls["mesh"] == 0
    assert meshed == single


WORKER = r"""
import sys
init, nproc, rank, fasta, prefix = sys.argv[1:6]

import torch.distributed as dist

from allwave_tpu_torch.parallel.dist import (
    DistributedAllPairAligner,
    init_distributed,
    process_topology,
)

init_distributed(init, int(nproc), int(rank))
assert process_topology() == (int(rank), int(nproc)), process_topology()

from allwave_tpu_torch.core.scores import parse_scores
from allwave_tpu_torch.core.types import NoSparsification
from allwave_tpu_torch.engine.fasta import read_fasta

seqs = read_fasta(fasta)
al = DistributedAllPairAligner(
    seqs,
    parse_scores("0,5,8,2,24,1"),
    exclude_self=True,
    use_mash_orientation=True,
    sparsification=NoSparsification(),
)
path = al.run_to_paf_shard(prefix)
print(f"shard {rank}: {al.pair_count()} pairs -> {path}")
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_matches_single(tmp_path):
    """tests/test_multihost.py's case (5 x 400, seed 42) on two
    processes joined by a gloo process group on 127.0.0.1."""
    from allwave_tpu_torch.core.paf import alignment_to_paf
    from allwave_tpu_torch.core.types import NoSparsification
    from allwave_tpu_torch.engine.fasta import read_fasta
    from allwave_tpu_torch.engine.pipeline import AllPairAligner
    from allwave_tpu_torch.parallel.dist import merge_paf_shards
    from allwave_tpu_torch.testing.synth import make_test_case

    fasta = str(tmp_path / "mh.fa")
    make_test_case(seed=42, n_sequences=5, length=400).write_fasta(fasta)
    prefix = str(tmp_path / "out")
    env = dict(os.environ, ALLWAVE_PLATFORM="cpu", PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, init, "2", str(rank), fasta, prefix],
            cwd=REPO,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for rank in range(2)
    ]
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    merged = str(tmp_path / "merged.paf")
    merge_paf_shards(prefix, 2, merged)
    seqs = read_fasta(fasta)
    single = []
    AllPairAligner(
        seqs,
        parse_scores("0,5,8,2,24,1"),
        exclude_self=True,
        use_mash_orientation=True,
        sparsification=NoSparsification(),
    ).for_each_with_callback(
        lambda r: single.append(alignment_to_paf(r, seqs) + "\n")
    )
    merged_lines = sorted(open(merged))
    assert len(merged_lines) == 20  # n(n-1) directed pairs, 5 seqs
    assert merged_lines == sorted(single)
