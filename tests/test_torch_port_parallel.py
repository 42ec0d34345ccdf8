"""The port's data parallelism (`garment4d_tpu_torch.parallel`) on the CPU.

- Launch: the `pytorch` and `slurm` launchers' environments read without
  a process group (a bracketed `SLURM_NODELIST` among them); no launcher is
  a no-op; `per_process_batch`, `check_batch_divisible` and
  `local_batch_indices` against the JAX package's `parallel/`; the kernel
  build's file lock, which lets one of several processes compile.
- A world-1 gloo group in this process: the global-batch BatchNorm and
  dropout equal the single-process ones.
- Two gloo ranks (tests/torch_dist_worker.py, one torch thread each, 240 s
  timeout) in float64 on the 48-vertex ring and the 200-vertex body, global
  B=4 (2 a rank), against one process at B=4:
  * the canonical train step (T=1, N=2048) against the JAX package's
    single-device step at the same weights, dropout off on both sides, JAX
    compiled without `algsimp` (`test_torch_port_canonical_train.py`'s
    reference and tolerances: losses 1e-5 relative, gradients 1e-4
    relative L2);
  * the same step with the dropout on against the port's own step in one
    process: gradients within 1e-9 relative L2, running statistics within
    1e-12, the dropout masks equal;
  * the posed train step (T=2, N=512, lbs_k 16) against one process;
  * the replicas bitwise equal after each step;
  * an eval epoch whose last global batch holds one real window, so that
    rank 1 holds only padding: the means equal one process's;
  * `train_temporal.main(..., device="cpu")` under `--launcher pytorch`
    against `main` in one process, two synthetic canonical epochs (fp32,
    global batch 4, `--lr 0`): every epoch's train and eval means, the
    saves and the checkpoint (Adam's moments among it) equal one
    process's to fp32 roundoff; rank 0 alone writes.
  The single-process references run in a third worker beside the ranks,
  while this process compiles JAX's step.
"""

import contextlib
import os
import socket
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from garment4d_tpu.parallel import launch as jlaunch
from garment4d_tpu.parallel import mesh as jmesh

from garment4d_tpu_torch import parallel, train_temporal
from garment4d_tpu_torch.data.synthetic import make_batch
from garment4d_tpu_torch.models import PosedGarmentModel
from garment4d_tpu_torch.models import GarmentAssets as TAssets
from garment4d_tpu_torch.nn import BatchNorm, Dropout
from garment4d_tpu_torch.nn import layers as nn_layers
from garment4d_tpu_torch.ops import _build
from garment4d_tpu_torch.parallel import launch
from garment4d_tpu_torch.smpl import synthetic_smpl
from garment4d_tpu_torch.train import loop
from garment4d_tpu_torch.train.convert import flax_to_torch
from test_torch_port_cli import disk  # noqa: F401
from test_torch_port_canonical_train import (  # noqa: F401
    jassets,
    jax_canonical_step,
    jax_step_inputs,
    jbody,
)
from torch_port_threads import one_torch_thread  # noqa: F401

WORLD, GLOBAL_B = 2, 4
LR = 1e-3
POSED_T, POSED_N, LBS_K = 2, 512, 16
# --lr 0: every step's forward sees the initial weights in both runs (see
# test_dp_entry_point)
ENTRY_ARGV = ["--config", "cfgs/skirt.yaml", "--synthetic_data", "1", "--GarmentPCA", "1",
              "--batch_size", str(GLOBAL_B), "--T", "1", "--npoints", "512", "--epoch_num", "2",
              "--lr", "0", "--lr_sche"]
WORKER_TIMEOUT = 240


def _rel_l2(got, want) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-300))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- launch, without a process group --------------------------------------------


@pytest.mark.parametrize("env,flag,want", [
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.2",
      "MASTER_PORT": "29500"}, 0, (3, 4, 1, "10.0.0.2", 29500)),
    ({"RANK": "1", "WORLD_SIZE": "2"}, 1, (1, 2, 1, "127.0.0.1", 12345)),
], ids=["torchrun", "local_rank_flag"])
def test_pytorch_launcher_env(env, flag, want):
    """torchrun's variables; without LOCAL_RANK / MASTER_* the old
    `--local_rank` flag and `--tcp_port` on the local host."""
    got = launch.process_env("pytorch", 12345, local_rank=flag, env=env)
    assert tuple(got[k] for k in ("rank", "world_size", "local_rank", "master_addr",
                                  "master_port")) == want


@pytest.mark.parametrize("nodelist,host", [
    ("node07", "node07"), ("node[01-02]", "node01"), ("gpu[3,5-7],cpu1", "gpu3"),
    ("a-1,b-2", "a-1"), ("rack1-[004-006]-gpu", "rack1-004-gpu")])
def test_slurm_launcher_env(nodelist, host):
    env = {"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
           "SLURM_NODELIST": nodelist}
    got = launch.process_env("slurm", 18888, env=env)
    assert got == dict(rank=5, world_size=8, local_rank=1, master_addr=host, master_port=18888)


def test_launcher_env_refusals():
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        launch.process_env("pytorch", 1, env={"RANK": "0"})
    with pytest.raises(ValueError, match="SLURM_NODELIST"):
        launch.process_env("slurm", 1, env={"SLURM_PROCID": "0", "SLURM_NTASKS": "1",
                                            "SLURM_LOCALID": "0", "SLURM_NODELIST": ""})
    with pytest.raises(ValueError, match="expected one of"):
        launch.process_env("mpi", 1, env={})


def test_no_launcher_is_a_no_op():
    info = parallel.initialize_distributed(None, device="cpu")
    assert (info["process_index"], info["process_count"], info["backend"]) == (0, 1, None)
    assert info["device"] == torch.device("cpu") and not dist.is_initialized()
    assert parallel.world_size() == 1 and parallel.is_main_process()
    parallel.barrier()  # outside a group: returns at once
    assert parallel.per_process_batch(16) == jlaunch.per_process_batch(16) == 16


@pytest.mark.parametrize("batch,count", [(8, 2), (20, 4), (3, 2), (6, 4)])
def test_per_process_batch(batch, count):
    """The share of each process, or JAX's ValueError and message."""
    if batch % count:
        with pytest.raises(ValueError, match=f"global batch {batch} not divisible by "
                                             f"process count {count}"):
            parallel.per_process_batch(batch, count)
    else:
        assert parallel.per_process_batch(batch, count) == batch // count


@pytest.mark.parametrize("batch", [8, 16, 3, 12])
def test_check_batch_divisible(batch):
    """AssertionError where the JAX package's check raises it, against its
    8-device mesh."""
    mesh = jmesh.make_mesh()
    n = mesh.shape[jmesh.DATA_AXIS]
    try:
        jmesh.check_batch_divisible(batch, mesh)
    except AssertionError:
        with pytest.raises(AssertionError, match="not divisible"):
            parallel.check_batch_divisible(batch, n)
    else:
        parallel.check_batch_divisible(batch, n)


@pytest.mark.parametrize("batch,count", [(4, 2), (20, 2), (20, 4), (8, 8), (6, 3), (12, 1)])
def test_local_batch_indices(batch, count):
    order = list(np.random.RandomState(batch * count).permutation(3 * batch)[:batch])
    for p in range(count):
        assert (parallel.local_batch_indices(order, p, count)
                == jmesh.local_batch_indices(order, p, count))


def test_shard_batch():
    """Every entry's leading axis cut to this rank's block, expanded views
    included."""
    full = {"pcd": torch.arange(4 * 3 * 2.0).reshape(4, 3, 2),
            "J_regressor": torch.ones(5, 7)[None].expand(4, 5, 7)}
    for p in range(2):
        got = parallel.shard_batch(full, p, 2)
        assert torch.equal(got["pcd"], full["pcd"][2 * p:2 * p + 2])
        assert got["J_regressor"].shape == (2, 5, 7)


def test_build_once_compiles_in_one_process(tmp_path):
    """Four threads, each with its own open file description of the lock
    (as separate processes have), build one target: one compiles, the
    others wait and find it built."""
    target = tmp_path / "lib.so"
    compiled, done = [], []

    def slow_compile(path):
        compiled.append(threading.get_ident())
        time.sleep(0.3)
        path.write_bytes(b"built")

    def build():
        done.append(_build.build_once(target, slow_compile))

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(compiled) == 1 and sorted(done) == [False, False, False, True]
    assert target.read_bytes() == b"built"
    assert _build.build_once(target, slow_compile) is False


def test_launcher_and_syncbn_are_served():
    """--launcher and --syncbn are no longer refused: they parse, and the
    entry point keeps no list of refused flags."""
    args, _ = train_temporal.parse_args(["--config", "cfgs/skirt.yaml", "--launcher", "slurm",
                                         "--syncbn", "1", "--tcp_port", "18888",
                                         "--local_rank", "1"])
    assert not hasattr(train_temporal, "_refuse_unported")
    assert (args.launcher, args.syncbn, args.tcp_port, args.local_rank) == ("slurm", 1, 18888, 1)


def test_cloth3d_batches_split_by_rank(disk, tmp_path, monkeypatch):  # noqa: F811
    """The CLOTH3D data path (`train_temporal.cloth3d_batches`) as each of
    two ranks would read it (`local_batch_indices` at rank r of 2, the
    train windows drawn from one seed, as `main` shares it over a group):
    at global batch 2 over the fixture's three windows, each rank's train and
    eval batches are one process's rows r, every key within 1e-6, and the
    eval tail's mask is split with them, so that rank 1's share of the last
    batch is padding alone."""
    args, cfg = train_temporal.parse_args([
        "--config", disk["cfg"], "--batch_size", "2", "--T", "3", "--num_workers", "0",
        "--smpl_model_dir", disk["smpl_dir"], "--GarmentPCA", "1",
        "--output_dir", str(tmp_path)])
    bodies = train_temporal._body_models(args, torch.device("cpu"))

    def read():
        loaders = []
        try:
            splits = train_temporal.cloth3d_batches(
                args, cfg, cfg.NETWORK.NPOINTS, bodies, torch.device("cpu"),
                loop.make_logger(None), loaders, window_seed=5)
            return [list(gen(0)) for gen in splits]
        finally:
            for loader in loaders:
                loader.close()

    single = read()
    ranks = []
    for r in range(2):
        monkeypatch.setattr(parallel, "local_batch_indices",
                            lambda rows, r=r: jmesh.local_batch_indices(rows, r, 2))
        ranks.append(read())
    assert [len(b) for b in single] == [1, 2]  # 3 windows: one train batch, a padded eval tail
    for split, want in enumerate(single):
        for i, batch in enumerate(want):
            parts = [rank[split][i] for rank in ranks]
            assert sorted(batch) == sorted(parts[0]) == sorted(parts[1])
            for k, v in batch.items():
                got = torch.cat([p[k] for p in parts])
                torch.testing.assert_close(got, v, rtol=1e-6, atol=1e-6, msg=k)
    assert torch.equal(ranks[0][1][1]["valid_mask"], torch.tensor([1.0]))
    assert torch.equal(ranks[1][1][1]["valid_mask"], torch.tensor([0.0]))


# ---- a world-1 group in this process ---------------------------------------------


@contextlib.contextmanager
def world_of_one():
    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()))
    try:
        yield parallel.initialize_distributed("pytorch", device="cpu")
    finally:
        for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(key, None)
        parallel.shutdown()


def test_world_of_one(rng):
    """In a group of one, a BatchNorm's output, gradients and running
    statistics (the global batch's) equal those outside any group to
    float64 roundoff, and a dropout draws the same mask from the same
    generator; the group alone switches them."""
    x = torch.from_numpy(rng.randn(37, 5) * 2 + 1).requires_grad_(True)
    cot = torch.from_numpy(rng.randn(37, 5))
    drop = Dropout(0.5).train()

    def run():
        bn = BatchNorm(5).double().train()
        y = bn(x)
        grads = torch.autograd.grad(y, [x, bn.weight, bn.bias], cot)
        return (y, *grads, bn.running_mean, bn.running_var,
                drop(x.detach(), torch.Generator().manual_seed(3)))

    plain = run()
    with world_of_one() as info:
        assert info["backend"] == "gloo" and parallel.in_group()
        assert isinstance(parallel.shared_seed(), int)
        with mock.patch.object(nn_layers, "global_moments",
                               wraps=nn_layers.global_moments) as moments:
            grouped = run()
        assert moments.call_count == 1
    assert not parallel.in_group()
    for a, b in zip(plain[:-1], grouped[:-1]):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)
    assert torch.equal(plain[-1], grouped[-1])


# ---- two gloo ranks -------------------------------------------------------------------


def _double(batch):
    return {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}


def _tail_batches(assets, body):
    """Two global eval batches: four windows, then one real window padded
    by three repeats (masked), so rank 1's share of it is all padding."""
    full = _double(make_batch(assets, body, batch_size=GLOBAL_B, T=1, npoints=2048, seed=7,
                              device="cpu"))
    one = _double(make_batch(assets, body, batch_size=1, T=1, npoints=2048, seed=8,
                             device="cpu"))
    tail = {k: torch.cat([v] * GLOBAL_B) for k, v in one.items()}
    tail["valid_mask"] = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    return [full, tail]


@pytest.fixture(scope="module")
def dp(jassets, jbody, tmp_path_factory):  # noqa: F811
    """The inputs written, the two ranks and the single process they are
    held against launched (tests/torch_dist_worker.py), JAX's reference
    step compiled and run meanwhile; then each process's records."""
    inputs_jax = jax_step_inputs(jassets, jbody, GLOBAL_B)
    workdir = tmp_path_factory.mktemp("torch_dp")
    assets = TAssets.synthetic(num_rings=6, ring_size=8)
    body = synthetic_smpl(num_verts=200, device="cpu")
    torch.manual_seed(0)
    posed = PosedGarmentModel(assets, jbody.faces, lbs_k=LBS_K, iterations=3)
    torch.save(dict(
        lr=LR, dropout_seed=0, lbs_k=LBS_K, body_faces=np.asarray(jbody.faces),
        canonical_weights=flax_to_torch(inputs_jax[1]),
        canonical_batch={k: torch.from_numpy(np.array(v)).double()
                         if v.dtype == np.float32 else torch.from_numpy(np.array(v))
                         for k, v in inputs_jax[0].items()},
        posed_weights=posed.state_dict(),
        posed_batch=_double(make_batch(assets, body, batch_size=GLOBAL_B, T=POSED_T,
                                       npoints=POSED_N, seed=3, device="cpu")),
        eval_batches=_tail_batches(assets, body), entry_argv=ENTRY_ARGV), workdir / "inputs.pt")

    ports = (_free_port(), _free_port())
    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    names = [str(r) for r in range(WORLD)] + ["single"]
    procs = [subprocess.Popen([sys.executable, worker, str(workdir), name, str(WORLD),
                               str(ports[0]), str(ports[1])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for name in names]
    try:
        jcase = jax_canonical_step(jassets, jbody, GLOBAL_B, inputs=inputs_jax)
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for name, p, out in zip(names, procs, outs):
        assert p.returncode == 0 and f"DIST_OK {name}" in out, f"{name} failed:\n{out}"
    got = {name: torch.load(workdir / f"{name}.pt", weights_only=False) for name in names}
    return dict(jax=jcase, single=got["single"], ranks=[got[str(r)] for r in range(WORLD)],
                workdir=workdir)


def test_dp_canonical_step_matches_jax(dp):
    """Each rank's global losses within 1e-5 relative of JAX's single-device
    step at B=4, and its averaged gradients within 1e-4 relative L2 where
    the reference gradient is not zero (where it is, exactly, both sides
    stay below 1e-9 of the largest: `test_torch_port_canonical_train.py`)."""
    _, _, jlosses, jgrads, _, _ = dp["jax"]
    largest = max(float(torch.linalg.vector_norm(g)) for g in jgrads.values())
    for r, got in enumerate(dp["ranks"]):
        case = got["canonical"]
        assert set(case["losses"]) == set(jlosses)
        for k, v in jlosses.items():
            np.testing.assert_allclose(float(case["losses"][k]), v, rtol=1e-5, atol=0,
                                       err_msg=f"rank {r} {k}")
        assert set(case["grads"]) == set(jgrads)
        for name, want in jgrads.items():
            g = case["grads"][name]
            if float(torch.linalg.vector_norm(want)) < 1e-9 * largest:
                assert float(torch.linalg.vector_norm(g)) < 1e-9 * largest, name
            else:
                assert _rel_l2(g, want) <= 1e-4, f"rank {r} {name}: {_rel_l2(g, want)}"


@pytest.mark.parametrize("case", ["canonical", "canonical_dropout"])
def test_dp_canonical_step_matches_single_process(dp, case):
    """Against the port's own step at B=4 in one process, the dropout off
    and on: every loss within 1e-12 relative, every gradient within 1e-9
    relative L2 (below 1e-9 of the largest where the reference's is), the
    running statistics within 1e-12; with the dropout on, each rank's
    dropped elements are the single-process step's on its rows."""
    want = dp["single"][case]
    largest = max(float(torch.linalg.vector_norm(g)) for g in want["grads"].values())
    for r, got in enumerate(dp["ranks"]):
        got = got[case]
        for k, v in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=0, err_msg=f"rank {r} {k}")
        assert set(got["grads"]) == set(want["grads"])
        for name, w in want["grads"].items():
            g = got["grads"][name]
            if float(torch.linalg.vector_norm(w)) < 1e-9 * largest:
                assert float(torch.linalg.vector_norm(g)) < 1e-9 * largest, name
            else:
                assert _rel_l2(g, w) <= 1e-9, f"rank {r} {name}: {_rel_l2(g, w)}"
        for name, w in want["buffers"].items():
            if "running" in name:
                torch.testing.assert_close(got["buffers"][name], w, rtol=1e-12, atol=1e-12)
        if case == "canonical_dropout":
            rows = want["dropped"].shape[0] // WORLD
            assert torch.equal(got["dropped"], want["dropped"][r * rows:(r + 1) * rows])
            assert got["dropped"].any()


def test_dp_posed_step_matches_single_process(dp):
    """The posed step (canonical stage frozen; no BatchNorm trains): every
    loss entry, the per-sample `lbs_garment_msre_list` gathered in rank
    order among them, within 1e-12 relative; gradients within 1e-9
    relative L2; the parameters after Adam within 1e-12; the frozen stage
    untouched."""
    want = dp["single"]["posed"]
    for r, got in enumerate(dp["ranks"]):
        got = got["posed"]
        assert set(got["losses"]) == set(want["losses"])
        for k, v in want["losses"].items():
            assert got["losses"][k].shape == v.shape, k
            np.testing.assert_allclose(got["losses"][k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-15, err_msg=f"rank {r} {k}")
        assert set(got["grads"]) == set(want["grads"]) and want["grads"]
        assert not any(n.startswith("canonical.") for n in got["grads"])
        for name, w in want["grads"].items():
            assert _rel_l2(got["grads"][name], w) <= 1e-9, name
        for name, w in want["params"].items():
            torch.testing.assert_close(got["params"][name], w, rtol=1e-12, atol=1e-12)


def test_dp_replicas_bitwise(dp):
    """After each step the two ranks hold the same losses, gradients,
    parameters and buffers, bit for bit; they drew the same shared seed."""
    a, b = dp["ranks"]
    assert a["seed"] == b["seed"]  # `shared_seed`: rank 0's draw on every rank
    for case in ("canonical", "canonical_dropout", "posed"):
        for part in ("losses", "grads", "params", "buffers"):
            assert set(a[case][part]) == set(b[case][part])
            for name, t in a[case][part].items():
                assert torch.equal(t, b[case][part][name]), f"{case} {part} {name}"


def test_dp_eval_tail(dp):
    """The tail batch leaves rank 1 only padding (its mask all 0); the
    reduced means equal one process's `eval_one_epoch` to 1e-12."""
    masks = [got["eval_masks"][1] for got in dp["ranks"]]
    assert torch.equal(masks[0], torch.tensor([1.0, 0.0], dtype=torch.float64))
    assert torch.equal(masks[1], torch.zeros(2, dtype=torch.float64))
    want = dp["single"]["eval"]
    for got in dp["ranks"]:
        assert sorted(got["eval"]) == sorted(want)
        for k, v in want.items():
            assert got["eval"][k] == pytest.approx(v, rel=1e-12, abs=1e-15), k


def test_dp_entry_point(dp):
    """`main` under `--launcher pytorch` against `main` in one process, two
    synthetic canonical epochs in fp32 at `--lr 0`: the group it made is
    gone after it; both ranks return the same history; the first step's
    losses and every epoch's train and eval means (global) within 1e-4
    relative of one process's (9b's loss limit on the card), so the
    plateau scale and the "new best" decisions are the same; rank 0 alone
    saved, at one process's epochs, and wrote `metrics.jsonl` with one
    process's tags in its order. The checkpoint: the weights bitwise one
    process's, the running statistics within 1e-4 of each tensor's largest
    magnitude (fp32 rounding of the forward reaches ~1e-5 at the PCA
    heads' BatchNorms, the deepest), step counts and `other_state` equal,
    Adam's moments within 2e-2 relative L2 (the JAX package's tolerance for
    a sharded fp32 step, `tests/test_parallel.py`; a moment below 1e-5 of
    its kind's largest, zero in exact arithmetic, held below 1e-4 of it on
    both sides), and it holds rank 1's state at that save bit for bit.

    At `--lr 0` the weights stay the initial ones in both runs, so the
    comparison reaches every step and both evaluations: with a learning
    rate, fp32 parts them after the first update (train-mode BatchNorms
    over a few rows make this step's gradients ill-conditioned: another
    summation order moves some near-zero elements across zero, and Adam
    moves each such element by about +-lr). The float64 steps above hold
    the updates themselves to 1e-9."""
    a, b = dp["ranks"]
    single = dp["single"]
    assert not a["group_after_main"] and not b["group_after_main"]
    assert a["history"] == b["history"] and a["first_step"] == b["first_step"]
    assert sorted(a["first_step"]) == sorted(single["first_step"])
    for k, v in single["first_step"].items():
        assert a["first_step"][k] == pytest.approx(v, rel=1e-4), k
    assert len(a["history"]) == len(single["history"]) == 2
    for got, want in zip(a["history"], single["history"]):
        assert got["epoch"] == want["epoch"]
        for split in ("train", "eval"):
            assert sorted(got[split]) == sorted(want[split])
            for k, v in want[split].items():
                assert got[split][k] == pytest.approx(v, rel=1e-4), (got["epoch"], split, k)
    dp_dir, single_dir = (os.path.join(dp["workdir"], d) for d in ("entry_dp", "entry_single"))
    assert a["saves"] == [(os.path.join(dp_dir, "ckpt", "model.ckpt"), e)
                          for _, e in single["saves"]] and single["saves"] and b["saves"] == []
    tags = []
    for d in (single_dir, dp_dir):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            tags.append([(line.split('"tag": "')[1].split('"')[0], line.split('"step": ')[1])
                         for line in f])
    assert tags[0] == tags[1]
    want, got = (torch.load(os.path.join(d, "ckpt", "model.ckpt"), weights_only=True)
                 for d in (single_dir, dp_dir))
    assert got["epoch"] == want["epoch"]
    assert got["other_state"]["step"] == want["other_state"]["step"]
    assert got["other_state"]["lr_scale"] == want["other_state"]["lr_scale"]
    assert got["other_state"]["best_v_l2"] == pytest.approx(want["other_state"]["best_v_l2"],
                                                            rel=1e-4)
    assert [(k, v.shape, v.dtype) for k, v in got["model_state"].items()] == [
        (k, v.shape, v.dtype) for k, v in want["model_state"].items()]
    for k, v in want["model_state"].items():
        if "running" in k:
            scale = float(v.abs().max().clamp_min(1e-30))
            assert float((got["model_state"][k] - v).abs().max()) <= 1e-4 * scale, k
        else:
            assert torch.equal(got["model_state"][k], v), k
    moments_got, moments_want = (ckpt["optimizer_state"]["state"] for ckpt in (got, want))
    assert sorted(moments_got) == sorted(moments_want) and moments_want
    for kind in ("exp_avg", "exp_avg_sq"):
        largest = max(float(torch.linalg.vector_norm(m[kind])) for m in moments_want.values())
        for i, m in moments_want.items():
            g, w = moments_got[i][kind], m[kind]
            assert float(moments_got[i]["step"]) == float(m["step"])
            if float(torch.linalg.vector_norm(w)) < 1e-5 * largest:
                assert float(torch.linalg.vector_norm(g)) < 1e-4 * largest, (kind, i)
            else:
                assert _rel_l2(g, w) <= 2e-2, (kind, i, _rel_l2(g, w))
    assert list(got["model_state"]) == list(b["saved_state"])
    for k, v in got["model_state"].items():
        assert torch.equal(v, b["saved_state"][k]), k
        assert torch.equal(v, a["saved_state"][k]), k
