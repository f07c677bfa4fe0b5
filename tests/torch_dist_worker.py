"""One rank of the multi-process CPU tests (``tests/test_torch_dist.py``):

    python tests/torch_dist_worker.py JOB RANK WORLD STORE DIR

joins a gloo group of WORLD ranks through the file STORE, runs JOB's
checks on the port's distributed path (reading DIR/inputs.pt where the
job needs the test's inputs), and writes what it computed to
DIR/JOB_RANK.pt for the test to hold against the JAX package and the
one-process runs.  Imports no JAX.
"""

import contextlib
import dataclasses
import os
import pathlib
import sys

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist import layout, sharding as shd  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

#: the smoke training runs: f32, 4 rows of 32 tokens a step
SEQ, BATCH = 32, 4


def smoke(arch, dtype="float32"):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


@contextlib.contextmanager
def chosen_layout(name):
    """``layout.choose_layout`` picking ``name`` (for the smoke model it
    would pick dp, which shards no leaf)."""
    choose = layout.choose_layout
    layout.choose_layout = lambda *args, **kwargs: name
    try:
        yield
    finally:
        layout.choose_layout = choose


def train_run(mesh, ckpt_dir):
    """``launch.train.train`` of smollm-360m-smoke to step 3 on ``mesh``
    under the FSDP layout (resuming from ``ckpt_dir`` when it holds a
    step): each step's loss and grad norm."""
    steps = {}
    with chosen_layout("fsdp"):
        train_launch.train(
            smoke("smollm-360m"), steps=3, seq_len=SEQ, global_batch=BATCH,
            device="cpu", ckpt_dir=str(ckpt_dir), ckpt_every=2, mesh=mesh,
            on_step=lambda s, st, m, t: steps.__setitem__(
                s, (float(m["loss"]), float(m["grad_norm"]))))
    return steps


def stepped(arch, mesh, layout_name, optimizer, n_steps=2, lr=1e-2,
            dtype="float32"):
    """``n_steps`` sharded steps from the seed-0 state at ``lr`` (no
    warmup): each step's loss, grad norm, whole gradients and whole new
    state."""
    cfg = smoke(arch, dtype)
    state = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu",
                          optimizer=optimizer)
    specs = elastic.state_specs(TS.state_struct(cfg, optimizer), cfg, mesh,
                                layout_name)
    compute = layout.compute_specs(specs.params)
    state = layout.shard_tree(state, specs, mesh)
    step = TS.make_train_step(cfg, optimizer=optimizer, peak_lr=lr,
                              warmup_steps=0, return_grads=True, mesh=mesh,
                              specs=specs)
    data = pipeline.DataConfig(seq_len=SEQ, global_batch=BATCH)
    out = []
    for i in range(n_steps):
        batch = train_launch.rank_rows(pipeline.make_batch(cfg, data, i),
                                       mesh)
        state, m = step(state, batch)
        out.append({"loss": m["loss"], "grad_norm": m["grad_norm"],
                    "grads": layout.gather_tree(m["grads"], compute, mesh),
                    "state": layout.gather_tree(state, specs, mesh)})
    return out


def world2(d):
    mesh = make_host_mesh(data=2, device="cpu")
    experts = make_host_mesh(data=1, model=2, device="cpu")
    out = {
        "train": train_run(mesh, d / "ckpt2"),
        "dense_fsdp": stepped("smollm-360m", mesh, "fsdp", "adamw"),
        "dense_bf16": stepped("smollm-360m", mesh, "fsdp", "adamw",
                              dtype="bfloat16"),
        "moe_ep": stepped("qwen3-moe-235b-a22b", experts, "fsdp_tp",
                          "adafactor"),
    }
    # the banks split on model, gathered by the layer off the EP path
    os.environ["REPRO_MOE_EP"] = "0"
    out["moe_off"] = stepped("qwen3-moe-235b-a22b", experts, "fsdp_tp",
                             "adafactor")
    del os.environ["REPRO_MOE_EP"]
    return out


def ep(inputs, mesh, banks, x=None):
    """The MoE layer on this rank's rows of ``x`` (default the inputs')
    and its experts: its output, aux loss, and the gradients of
    sum(y ** 2) (this rank's terms)."""
    i = mesh.coord["data"]
    x = inputs["x"] if x is None else x
    rows = x.shape[0] // shd.axis_sizes(mesh)["data"]
    xl = x[i * rows:(i + 1) * rows].clone().requires_grad_()
    p = {"router": inputs["moe"]["router"].clone()}
    for k in ("w_gate", "w_up", "w_down"):
        w = banks[k]
        p[k] = {n: shd.shard(v, shd.P("model"), mesh) for n, v in w.items()} \
            if isinstance(w, dict) else shd.shard(w, shd.P("model"), mesh)
    leaves = {k: v for k, v in p.items() if not isinstance(v, dict)}
    for v in leaves.values():
        v.requires_grad_()
    with shd.use_mesh(mesh):
        y, aux = M.moe_ffn(p, xl, top_k=inputs["top_k"],
                           capacity_factor=16.0)
        if leaves.keys() == p.keys():
            (y ** 2).sum().backward()
    return {"y": y.detach(), "aux": aux.detach(),
            "grads": {k: v.grad for k, v in leaves.items()},
            "dx": xl.grad}


def collectives_check(rank, world):
    """The Functions' forward and backward rules on bf16 and int32."""
    g = dist.group.WORLD
    x = (torch.arange(world * 3, dtype=torch.float32) + 10 * rank) \
        .to(torch.bfloat16).reshape(world, 3).requires_grad_()
    a2a = coll.all_to_all(x, g)
    (a2a.float() * (rank + 1)).sum().backward()
    leaf = x.detach().clone().requires_grad_()
    gathered = coll.all_gather(leaf, 1, g)
    (gathered.float() ** 2).sum().backward()
    ids = coll.all_reduce(torch.tensor([rank], dtype=torch.int32), g)
    return {"x": x.detach(), "a2a": a2a.detach(), "a2a_grad": x.grad,
            "gather": gathered.detach(), "gather_grad": leaf.grad,
            "ids": ids}


def world4(d):
    rank, world = dist.get_rank(), dist.get_world_size()
    inputs = torch.load(d / "inputs.pt")
    mesh = shd.make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coord": mesh.coord, "collectives": collectives_check(rank, world)}
    out["ep"] = ep(inputs, mesh, inputs["moe"])
    out["ep_int8"] = ep(inputs, mesh, inputs["moe_int8"])
    os.environ["REPRO_MOE_GROUPED"] = "0"
    out["ep_dense"] = ep(inputs, mesh, inputs["moe"])
    del os.environ["REPRO_MOE_GROUPED"]
    # off the EP path: every bank gathered over model
    os.environ["REPRO_MOE_EP"] = "0"
    out["ep_off"] = ep(inputs, mesh, inputs["moe"])
    del os.environ["REPRO_MOE_EP"]
    out["ep_odd"] = ep(inputs, mesh, inputs["moe"], inputs["x_odd"])
    grads, err = inputs["compress"][rank]
    out["compress"] = compression.compress_psum(grads, err,
                                                dist.group.WORLD)
    out["resume"] = train_run(make_host_mesh(data=4, device="cpu"),
                              d / "resume4")
    return out


def main():
    job, rank, world, store, d = sys.argv[1:]
    rank, world, d = int(rank), int(world), pathlib.Path(d)
    torch.set_num_threads(1)
    coll.init_process_group("cpu", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        out = {"world2": world2, "world4": world4}[job](d)
        torch.save(out, d / f"{job}_{rank}.pt")
        coll.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
