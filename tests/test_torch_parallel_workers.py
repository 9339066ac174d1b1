"""Rank workers of the port's multi-process CPU tests.

A helper module like test_torch_scenes.py: it imports nothing of JAX, so
the ranks that ``run_world`` spawns stay light. Each world is gloo over a
``FileStore`` under the test's ``tmp_path`` (no port is opened), one torch
thread per rank; inputs come in through files the parent writes, and every
rank writes its results to ``<name>_rank<r>.pt`` for the parent to
compare.
"""

import multiprocessing
import os
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from my_depthsplat_torch.parallel import MeshCfg, initialize_distributed, make_mesh, set_mesh

WORLD_TIMEOUT_S = 240


def run_world(name: str, world: int, out: Path, arg=None, device: str = "cpu") -> list[dict]:
    """Run worker ``name`` of this module on ``world`` spawned gloo ranks
    computing on ``device`` (on the card every rank shares it) and return
    each rank's results; raises with the failing ranks' tracebacks, or when
    the world outlives ``WORLD_TIMEOUT_S``."""
    return join_world(start_world(name, world, out, arg, device))


def start_world(name: str, world: int, out: Path, arg=None, device: str = "cpu"):
    """``run_world``'s ranks, started; ``join_world`` waits for them, so the
    parent can work meanwhile."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    store = out / f"{name}.store"
    store.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(name, r, world, str(store), str(out), arg, device)) for r in range(world)]
    for p in procs:
        p.start()
    return name, out, procs


def join_world(started) -> list[dict]:
    name, out, procs = started
    world = len(procs)
    for p in procs:
        p.join(WORLD_TIMEOUT_S)
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(out / f"{name}_rank{r}.err").read_text() for r in range(world) if (out / f"{name}_rank{r}.err").exists()]
    if alive or errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(
            f"world {name!r}: ranks {alive} still running after {WORLD_TIMEOUT_S} s, exit codes "
            f"{[p.exitcode for p in procs]}\n" + "\n".join(errors)
        )
    return [torch.load(out / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_entry(name, rank, world, store, out, arg, device):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    out = Path(out)
    try:
        initialize_distributed(device, store=dist.FileStore(store, world))
        result = globals()[name](rank, world, out, arg)
        torch.save(result, out / f"{name}_rank{rank}.pt")
    except BaseException:
        (out / f"{name}_rank{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def register_vitt_port() -> str:
    """The narrow test-only ViT of test_torch_unimatch_encoder.py, in the
    port alone (a spawned rank has no monkeypatch)."""
    from my_depthsplat_torch.models import unimatch, vit

    vit.VIT_CONFIGS["vitt"] = vit.ViTConfig(embed_dim=96, depth=4, num_heads=2)
    vit.INTERMEDIATE_LAYER_IDX["vitt"] = [0, 1, 2, 3]
    unimatch.DPT_MODEL_CONFIGS["vitt"] = {"features": 16, "out_channels": (8, 16, 32, 32)}
    return "vitt"


# ---- workers: (rank, world, out, arg) -> dict of results


def mesh_and_ring(rank, world, out, arg):
    """The mesh's coordinates and groups for each (data, model) grid of
    ``arg["grids"]``; the ring attention's forward for each (splits,
    with_shift) of ``arg["configs"]`` on ring_in.npz's q, k, v over all
    ranks, its gradients on ring_grad_in.npz's, and whether V % P != 0
    raises."""
    from my_depthsplat_torch.parallel import ring_cross_view_attention

    res = {"coords": {}}
    for grid in arg["grids"]:
        mesh = make_mesh(MeshCfg(*grid))
        res["coords"][grid] = {name: (mesh.axis(name).index, mesh.axis(name).ranks) for name in mesh.axis_names}
    axis = make_mesh(MeshCfg(1, world)).axis("model")
    full = [torch.from_numpy(x) for x in np.load(out / "ring_in.npz").values()]
    for splits, shift in arg["configs"]:
        res[(splits, shift)] = ring_cross_view_attention(*full, axis, splits, shift).numpy()
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in np.load(out / "ring_grad_in.npz").values()]
    torch.sin(ring_cross_view_attention(*qkv, axis, 2, True)).sum().backward()
    res["grads"] = [x.grad.numpy() for x in qkv]
    try:
        ring_cross_view_attention(*(x[:, :6] for x in full), axis)
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def sharded_render(rank, world, out, arg):
    """render_pallas_depth_sharded of sharded_in.npz's scene over all
    ranks, in groups of ``arg["slots"]`` gaussians, on ``arg["device"]``:
    the image, the kernel launches it made (kernel A's count and write
    passes, the chained composite; the card only), and whether its backward
    raises."""
    from my_depthsplat_torch.render import render_pallas_depth_sharded
    from my_depthsplat_torch.render.expand import expand_tiles
    from my_depthsplat_torch.render.pallas_raster import composite_chained

    dev = torch.device(arg["device"], torch.cuda.current_device()) if arg["device"] == "cuda" else "cpu"
    mesh = make_mesh(MeshCfg(1, world))
    set_mesh(mesh)
    data = dict(np.load(out / "sharded_in.npz"))
    shape = tuple(int(x) for x in data.pop("shape"))
    t = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    args = (t["extr"], t["intr"], t["near"], t["far"], shape, t["bg"])
    counters = ((expand_tiles, "launches"), (expand_tiles, "write_launches"), (composite_chained, "launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    image = render_pallas_depth_sharded("model", *args, t["means"], t["cov"], t["sh"], t["opac"], group_slots=arg["slots"])
    launches = [getattr(fn, attr) for fn, attr in counters]
    opac = t["opac"].clone().requires_grad_(True)
    try:
        render_pallas_depth_sharded(
            "model", *args, t["means"], t["cov"], t["sh"], opac, group_slots=arg["slots"]
        ).sum().backward()
        raised = None
    except NotImplementedError as e:
        raised = str(e)
    return {"image": image.cpu().numpy(), "launches": launches, "backward": raised}


def sharded_encoder(rank, world, out, arg):
    """The UniMatch encoder of encoder_in.pt (cfg kwargs, state dict,
    context) on a mesh of shape ``arg["grid"]`` named ``arg["axes"]``,
    ``spmd_view_axis`` on the first, ``spmd_depth_axis`` on the second: its
    gaussian means."""
    from my_depthsplat_torch.models import EncoderDepthSplat, EncoderDepthSplatCfg

    register_vitt_port()
    blob = torch.load(out / "encoder_in.pt", weights_only=False)
    view, depth = arg["axes"]
    set_mesh(make_mesh(MeshCfg(*arg["grid"]), arg["axes"]))
    cfg = EncoderDepthSplatCfg(**blob["cfg"], spmd_view_axis=view, spmd_depth_axis=depth)
    enc = EncoderDepthSplat(cfg, device="cpu").eval()
    enc.load_state_dict(blob["state"])
    with torch.no_grad():
        out = enc({k: torch.from_numpy(v) for k, v in blob["context"].items()})
    return {"means": out["gaussians"].means.numpy(), "depths": out["depths"].numpy()}


def train_steps(rank, world, out, arg):
    """For each (data, model) grid of ``arg["grids"]``: the steps of
    train_in.pt's TrainCfg from its state dict on that mesh, each on this
    rank's rows of the step's batch: the logs, each step's reduced gradients
    (read before the optimizer's update) and the parameters after each
    step."""
    import dataclasses

    from my_depthsplat_torch.parallel import shard_batch
    from my_depthsplat_torch.train import make_train_step

    register_vitt_port()
    blob = torch.load(out / "train_in.pt", weights_only=False)
    res = {}
    for grid in arg["grids"]:
        mesh = make_mesh(MeshCfg(*grid))
        set_mesh(mesh)
        cfg = blob["cfg"]
        if grid[1] > 1:
            cfg = dataclasses.replace(
                cfg, encoder=dataclasses.replace(cfg.encoder, spmd_depth_axis="model", spmd_view_axis="model")
            )
        init_fn, step = make_train_step(cfg, device="cpu", mesh=mesh)
        state = init_fn(seed=0)
        state.model.load_state_dict(blob["state"])
        named = dict(state.model.named_parameters())
        grads = []
        state.optimizer.register_step_pre_hook(
            lambda opt, a, kw: grads.append({k: p.grad.clone() for k, p in named.items()})
        )
        logs, params = [], []
        for batch in blob["batches"]:
            logs.append({k: float(v) for k, v in step(state, shard_batch(mesh, batch, cfg.grad_accum)).items()})
            params.append({k: p.detach().clone() for k, p in named.items()})
        res[grid] = {"logs": logs, "grads": grads, "params": params}
    return res


def cli_train(rank, world, out, arg):
    """``main.train(cfg, device="cpu")`` of ``arg["yaml"]`` with each list
    of ``arg["runs"]``' overrides in turn (the narrow ViT registered as the
    CLI test does): each run's final step and this rank's parameters."""
    from my_depthsplat_torch import main as port_main
    from my_depthsplat_torch.config import load_config

    register_vitt_port()
    res = []
    for overrides in arg["runs"]:
        state = port_main.train(load_config(arg["yaml"], overrides), device="cpu")
        res.append({"step": state.step, "params": {k: p.detach().clone() for k, p in state.model.named_parameters()}})
    return res
