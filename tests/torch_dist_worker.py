"""One rank of the port's two-process data-parallel test on the CPU (gloo),
or the single process it is held against.

Run as: python tests/torch_dist_worker.py <workdir> <rank|single> <world> <port> <port2>

The counterpart of tests/dist_worker.py for `garment4d_tpu_torch.parallel`.
It reads `<workdir>/inputs.pt` (written by tests/test_torch_port_parallel.py)
and, on one torch thread:

1. runs the entry point, `train_temporal.main(..., device="cpu")`, as a
   rank with `--launcher pytorch` from torchrun's environment (`RANK`,
   `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT=<port>`; every rank with the
   same `--output_dir`), or as one process without it; it records the
   first step's loss scalars, this process's `save_checkpoint` calls
   (path, epoch) and the model's state at the last `save_on_main`;
2. as a rank, joins a second group (`initialize_distributed("pytorch")` on
   <port2>); then, in float64, on its rows of each global batch (all of
   them as the single process): the canonical train step with the dropout
   off and with it on (the elements the dropout zeroed recorded), the
   posed train step, and a canonical eval epoch whose last global batch
   ends in padding;
3. writes what it saw to `<workdir>/<rank|single>.pt` and prints DIST_OK.

TensorBoard's scalar writer is given its stub of TensorFlow (an empty
`tensorboard.compat.notf`), as TensorBoard allows: importing the real one,
where it is installed, takes longer than the rest of the run.
"""

import os
import sys
import types

workdir, who = sys.argv[1], sys.argv[2]
world, port, port2 = map(int, sys.argv[3:6])
single = who == "single"
rank = 0 if single else int(who)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.modules["tensorboard.compat.notf"] = types.ModuleType("tensorboard.compat.notf")

import torch  # noqa: E402

torch.set_num_threads(1)

from garment4d_tpu_torch import parallel, train_temporal  # noqa: E402
from garment4d_tpu_torch.models import (  # noqa: E402
    CanonicalGarmentModel,
    GarmentAssets,
    PosedGarmentModel,
)
from garment4d_tpu_torch.train import checkpoint, loop  # noqa: E402
from garment4d_tpu_torch.train import (  # noqa: E402
    make_canonical_steps,
    make_posed_steps,
    make_state_for,
)

inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
out = {}

# ---- 1. the entry point ------------------------------------------------------
saves, steps, saved_states = [], [], []
save_checkpoint, save_on_main = checkpoint.save_checkpoint, checkpoint.save_on_main
host_scalars = loop.host_scalars


def counting_save(*args, **kwargs):
    saves.append((args[0], args[2]))
    return save_checkpoint(*args, **kwargs)


def recording_save_on_main(path, state, *args, **kwargs):
    saved_states.append({k: v.detach().clone() for k, v in state.model.state_dict().items()})
    return save_on_main(path, state, *args, **kwargs)


def recording_scalars(*args):
    out = host_scalars(*args)
    steps.append(out[0])
    return out


checkpoint.save_checkpoint, checkpoint.save_on_main, loop.host_scalars = (
    counting_save, recording_save_on_main, recording_scalars)
argv = inputs["entry_argv"] + [
    "--output_dir", os.path.join(workdir, "entry_single" if single else "entry_dp")]
if not single:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    argv += ["--launcher", "pytorch"]
out["history"] = train_temporal.main(argv, device="cpu")
checkpoint.save_checkpoint, checkpoint.save_on_main, loop.host_scalars = (
    save_checkpoint, save_on_main, host_scalars)
out.update(saves=saves, first_step=steps[0], saved_state=saved_states[-1],
           group_after_main=torch.distributed.is_initialized())

# ---- 2. the steps, in float64 ------------------------------------------------
if not single:
    os.environ["MASTER_PORT"] = str(port2)
    info = parallel.initialize_distributed("pytorch", device="cpu")
    assert (info["process_index"], info["process_count"], info["backend"]) == (rank, world, "gloo")
    out["seed"] = parallel.shared_seed()


def share(batch):
    return batch if single else parallel.shard_batch(batch)


assets = GarmentAssets.synthetic(num_rings=6, ring_size=8)
faces = inputs["body_faces"]


def canonical_state(dropout: bool):
    model = CanonicalGarmentModel(assets)
    model.load_state_dict(inputs["canonical_weights"], strict=True)
    model.double()
    if not dropout:
        model.pointnet.dropout.p = 0.0
    return make_state_for(model, lr=inputs["lr"])


def snapshot(state, losses):
    return dict(losses={k: v.clone() for k, v in losses.items()},
                grads={n: p.grad.clone() for n, p in state.model.named_parameters()
                       if p.grad is not None},
                params={n: p.detach().clone() for n, p in state.model.named_parameters()},
                buffers={n: b.clone() for n, b in state.model.named_buffers()})


batch = share(inputs["canonical_batch"])
for dropout in (False, True):
    state = canonical_state(dropout)
    train_step, _ = make_canonical_steps(state.model, assets, faces)
    dropped = []
    hook = state.model.pointnet.dropout.register_forward_hook(
        lambda m, args, y: dropped.append((y == 0) & (args[0] != 0)))
    losses = train_step(state, batch, torch.Generator().manual_seed(inputs["dropout_seed"]))
    hook.remove()
    out["canonical_dropout" if dropout else "canonical"] = dict(
        snapshot(state, losses), dropped=dropped[0] if dropout else None)

posed = PosedGarmentModel(assets, faces, lbs_k=inputs["lbs_k"], iterations=3)
posed.load_state_dict(inputs["posed_weights"], strict=True)
posed.double()
state = make_state_for(posed, lr=inputs["lr"], freeze_canonical=True)
train_step, _ = make_posed_steps(posed, assets, faces)
losses = train_step(state, share(inputs["posed_batch"]))
out["posed"] = snapshot(state, losses)

state = canonical_state(dropout=True)
_, eval_step = make_canonical_steps(state.model, assets, faces)
out["eval"] = loop.eval_one_epoch(state, [share(b) for b in inputs["eval_batches"]], eval_step)
out["eval_masks"] = [share(b).get("valid_mask") for b in inputs["eval_batches"]]
if not single:
    parallel.barrier()
    parallel.shutdown()

torch.save(out, os.path.join(workdir, f"{who}.pt"))
print(f"DIST_OK {who}", flush=True)
