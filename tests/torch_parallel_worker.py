"""The ranks of the parallel tests (tests/test_torch_parallel*.py,
tests/test_torch_tensor_parallel.py): each
function here runs in one of the gloo processes that
``torch.multiprocessing.spawn`` starts, imports the port only (no jax), runs
its checks on inputs the test wrote with ``torch.save`` and writes what it
computed to ``<out>/rank<r>.pt`` for the test to hold against the JAX
package."""

import contextlib
import copy
import os

import torch
import torch.distributed as dist


def run(rank: int, world: int, directory: str, task: str) -> None:
    """Joins the gloo group (``init_distributed_training`` with
    ``device="cpu"``) through a file store in ``directory`` (no TCP port:
    the suite runs in parallel workers), runs ``task`` on
    ``directory/inputs.pt`` and writes ``directory/rank<r>.pt``."""
    from pytorchvideo_tpu_torch.parallel import init_distributed_training

    torch.set_num_threads(1)
    init_distributed_training(f"file://{os.path.join(directory, 'store')}", num_processes=world,
                              process_id=rank, device="cpu")
    try:
        inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
        out = TASKS[task](rank, world, inputs)
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start(directory: str, task: str, world: int = 4):
    """Starts ``task`` on ``world`` ranks and returns at once (the test
    computes its references meanwhile); :func:`collect` waits for them."""
    import torch.multiprocessing as mp

    return mp.start_processes(run, args=(world, directory, task), nprocs=world, join=False,
                              start_method="spawn")


def collect(context, directory: str) -> list:
    """Waits for the ranks of :func:`start` (raising if one failed) and
    returns each rank's output."""
    while not context.join():
        pass
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(len(context.processes))]


def spawn(directory: str, task: str, world: int = 4) -> list:
    """Runs ``task`` on ``world`` ranks; returns each rank's output."""
    return collect(start(directory, task, world), directory)


@contextlib.contextmanager
def one_rank_group(directory: str):
    """A gloo default group of this process alone (its file store in
    ``directory``), destroyed on exit."""
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(directory, 'store1')}",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


# --- the primitives ----------------------------------------------------------

def _collectives(rank, inputs):
    from pytorchvideo_tpu_torch.parallel import all_gather_with_grad, cat_all_gather

    out = {}
    for name, fn in (("all_gather_with_grad", all_gather_with_grad),
                     ("cat_all_gather", cat_all_gather)):
        x = inputs["gather_x"][rank].clone().requires_grad_()
        y = fn(x)
        (y * inputs[f"{name}_w"][rank]).sum().backward()
        out[name] = (y.detach(), x.grad)
    return out


def _mesh(world):
    from pytorchvideo_tpu_torch.parallel import (
        batch_sharding,
        get_local_size,
        get_rank,
        get_world_size,
        local_sync_groups,
        make_mesh,
        replicated,
    )

    out = {"world": get_world_size(), "local": get_local_size(), "rank": get_rank(),
           "local_sync_groups": local_sync_groups(2)}
    for shapes, names in (((-1,), ("data",)), ((2, -1), ("data", "model")),
                          ((-1, 2), ("data", "model"))):
        mesh = make_mesh(shapes, names)
        out[f"mesh {shapes}"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names),
                                 mesh.mesh.tolist(), [str(p) for p in batch_sharding(mesh)],
                                 [str(p) for p in replicated(mesh)])
    errors = {}
    for shapes, names in (((3,), ("data",)), ((3, -1), ("data", "model")),
                          ((2, 4), ("data", "model")), ((0, -1), ("data", "model"))):
        try:
            make_mesh(shapes, names)
            errors[str(shapes)] = None
        except ValueError as e:
            errors[str(shapes)] = str(e)
    out["mesh_errors"] = errors
    return out


def _batch_norm(rank, inputs):
    from pytorchvideo_tpu_torch.layers import BatchNorm
    from pytorchvideo_tpu_torch.parallel import new_local_sync_groups

    local, _ = new_local_sync_groups(2)
    out = {}
    for name, group in (("global", dist.group.WORLD), ("local", local)):
        for case, xs in (("random", inputs["bn_x"]), ("constant", inputs["bn_const"])):
            weight, bias, mean, var = inputs["bn_params"]
            bn = BatchNorm(len(weight), process_group=group)
            with torch.no_grad():
                bn.weight.copy_(weight)
                bn.bias.copy_(bias)
                bn.running_mean.copy_(mean if case == "random" else torch.zeros_like(mean))
                bn.running_var.copy_(var)
            bn = copy.deepcopy(bn).train()  # a copy syncs over the same group
            x = xs[rank].clone().requires_grad_()
            y = bn(x)
            (y * inputs["bn_w"][rank]).sum().backward()
            out[(name, case)] = (y.detach(), x.grad, bn.running_mean.clone(),
                                 bn.running_var.clone())
    return out


def _ntxent(rank, inputs):
    from pytorchvideo_tpu_torch.layers import MultilayerPerceptron
    from pytorchvideo_tpu_torch.models import SimCLR
    from pytorchvideo_tpu_torch.train import ntxent_loss

    out = {}
    z1 = inputs["z1"][rank].clone().requires_grad_()
    z2 = inputs["z2"][rank].clone().requires_grad_()
    loss = ntxent_loss(z1, z2, inputs["temperature"], group=dist.group.WORLD)
    loss.backward()
    out["ntxent"] = (loss.detach(), z1.grad, z2.grad)
    simclr = SimCLR(MultilayerPerceptron(inputs["mlp_dims"], final_activation=None, device="cpu"),
                    temperature=inputs["temperature"])
    simclr.load_state_dict(inputs["simclr_state"], strict=True)
    x1 = inputs["x1"][rank].clone().requires_grad_()
    x2 = inputs["x2"][rank].clone().requires_grad_()
    loss = simclr.loss(x1, x2, group=dist.group.WORLD)
    loss.backward()
    out["simclr"] = (loss.detach(), x1.grad, x2.grad,
                     {n: p.grad for n, p in simclr.named_parameters()})
    return out


def _sequence(rank, inputs):
    from pytorchvideo_tpu_torch.parallel import sequence_parallel_attention

    out = {}
    q, k, v, heads, scale = inputs["attention"]
    for kv_sharded in (False, True):
        for residual in (False, True):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            y = sequence_parallel_attention(*leaves, heads, scale, residual,
                                            kv_sharded=kv_sharded)
            y.square().sum().backward()
            out[(kv_sharded, residual)] = (y.detach(), *(t.grad for t in leaves))
    errors = []
    for kv_sharded, (lq, lk) in ((False, (q.shape[1] - 2, k.shape[1])),
                                 (True, (q.shape[1], k.shape[1] - 2))):
        try:
            sequence_parallel_attention(q[:, :lq], k[:, :lk], v[:, :lk], heads, scale,
                                        kv_sharded=kv_sharded)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def primitives(rank, world, inputs):
    return {"collectives": _collectives(rank, inputs), "mesh": _mesh(world),
            "batch_norm": _batch_norm(rank, inputs), "ntxent": _ntxent(rank, inputs),
            "sequence": _sequence(rank, inputs)}


# --- the data-parallel step and the app --------------------------------------

def _x3d(inputs, dtype):
    from pytorchvideo_tpu_torch.models.x3d import create_x3d

    model = create_x3d(**inputs["x3d"], device="cpu")
    model.load_state_dict(inputs["state_dict"], strict=True)
    return model.to(dtype).train()


def _patch_mix(inputs):
    """The batch transform's draws fixed to the test's lambda and box
    centre, as the JAX side's are (the two frameworks draw different bits)."""
    from pytorchvideo_tpu_torch.transforms import mix

    lam, centre = inputs["lam"], inputs["centre"]
    mix._sample_beta = lambda alpha, generator: lam
    mix._sample_center = lambda h, w, generator: centre


def _dp_steps(rank, world, inputs, case):
    from pytorchvideo_tpu_torch.layers import set_sync_group
    from pytorchvideo_tpu_torch.parallel import make_mesh, shard_batch
    from pytorchvideo_tpu_torch.train import (
        MixVideoBatchWrapper,
        OptimizerConfig,
        TrainState,
        construct_optimizer,
        lr_schedule_from_config,
        make_train_step,
    )
    from pytorchvideo_tpu_torch.train.lr_policy import LRSchedulerConfig

    dtype = torch.float64 if case["float64"] else torch.float32
    model = _x3d(inputs, dtype)
    set_sync_group(model, dist.group.WORLD)
    mesh = make_mesh()
    state = TrainState(model, construct_optimizer(model, OptimizerConfig(**inputs["optim"])),
                       lr_schedule_from_config(LRSchedulerConfig(**inputs["sched"]), 1))
    transform = None
    if case["mix"]:
        transform = MixVideoBatchWrapper(num_classes=inputs["classes"],
                                         **case["mix"]).mix_video_transform
    step = make_train_step(batch_transform=transform, grad_accum_steps=case["accum"],
                           clip_grad_norm=case["clip"], process_group=dist.group.WORLD)
    losses = []
    for video, labels in case["batches"]:
        local = shard_batch({"video": video.to(dtype), "label": labels}, mesh,
                            microbatches=case["accum"], mirrored=bool(case["mix"]))
        state, metrics = step(state, local, torch.Generator().manual_seed(0))
        losses.append(metrics["loss"].item())
    return {"losses": losses, "state_dict": {k: v.clone() for k, v in model.state_dict().items()}}


def _layouts(inputs):
    """The rows the app takes of each layout case's batch on this rank, or
    the ValueError it raises."""
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, config_from_dict

    out = {}
    for name, case in inputs["layout_cases"].items():
        app = VideoClassificationTrainApp(config_from_dict(case["config"]),
                                          model=_x3d(inputs, torch.float32),
                                          datamodule=_Batches([]), device="cpu")
        try:
            out[name] = app._device_batch(case["batch"])["label"].tolist()
        except ValueError as e:
            out[name] = str(e)
    return out


def training(rank, world, inputs):
    _patch_mix(inputs)
    return {"steps": {name: _dp_steps(rank, world, inputs, case)
                      for name, case in inputs["cases"].items()},
            "app": app_run(inputs), "layouts": _layouts(inputs)}


class _Batches:
    """A datamodule of the test's global batches, the same on every rank."""

    def __init__(self, batches):
        self.batches = batches

    def train_dataloader(self, n):
        return iter([{"video": v, "label": y} for v, y in self.batches[:n]])

    def val_dataloader(self, _):
        return iter([{"video": v, "label": y, "video_index": torch.arange(len(y))}
                     for v, y in self.batches])


def app_run(inputs):
    """The classification app on the test's batches (CPU; data-parallel where
    a gloo group is initialised): its losses, state, predictions and the
    rows each step saw."""
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, config_from_dict

    out = {}
    for name, case in inputs["app_cases"].items():
        cfg = config_from_dict(case["config"])
        app = VideoClassificationTrainApp(cfg, model=_x3d(inputs, torch.float32),
                                          datamodule=_Batches(case["batches"]),
                                          steps_per_epoch=len(case["batches"]), device="cpu",
                                          seed=3)
        rows = []
        device_batch = app._device_batch

        def recorded(batch, device_batch=device_batch, rows=rows):
            out = device_batch(batch)
            rows.append(len(out["label"]))
            return out

        app._device_batch = recorded
        history = app.train()
        out[name] = {"history": history, "rows": rows, "mesh": app.mesh is not None,
                     "state_dict": {k: v.clone() for k, v in app.model.state_dict().items()},
                     "predict": app.predict()}
    return out


# --- tensor parallelism, FSDP and sequence parallelism on a (2, 2) mesh ------

def _mvit(config, state_dict):
    from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers

    model = create_multiscale_vision_transformers(**config, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


def _shards(model, plan):
    """{name: (local numel, full numel, momentum numel or None)} of every
    split parameter."""
    return {n: (p.numel(), plan.full_shapes[n].numel(), None)
            for n, p in model.named_parameters() if n in plan.full_shapes}


def _momenta(model, optimizer, shards):
    for n, p in model.named_parameters():
        if n in shards:
            buf = optimizer.state.get(p, {}).get("momentum_buffer")
            shards[n] = (*shards[n][:2], None if buf is None else buf.numel())
    return shards


def _mesh_step(model, case, mesh):
    """One step of ``case`` (rules, FSDP, optimizer, clip) over ``mesh`` on
    this rank's rows: (loss, the full state, the shards' numels)."""
    from pytorchvideo_tpu_torch.parallel import infer_param_shardings, shard_batch, shard_model_
    from pytorchvideo_tpu_torch.train import (
        OptimizerConfig,
        construct_optimizer,
        create_train_state,
        make_train_step,
    )

    placements = infer_param_shardings(model, mesh, case["rules"], case["fsdp_axis"], 256)
    plan = shard_model_(model, placements, mesh)
    state = create_train_state(model, construct_optimizer(model, OptimizerConfig(**case["optim"])))
    step = make_train_step(clip_grad_norm=case["clip"], sharding=plan)
    batch = shard_batch({"video": case["video"], "label": case["label"]}, mesh)
    state, metrics = step(state, batch)
    return (metrics["loss"].item(), plan.full_state_dict(model),
            _momenta(model, state.optimizer, _shards(model, plan)))


def tensor_parallel(rank, world, inputs):
    from pytorchvideo_tpu_torch.models.slowfast import create_slowfast
    from pytorchvideo_tpu_torch.models.x3d import create_x3d
    from pytorchvideo_tpu_torch.parallel import (
        MEGATRON_ATTENTION_RULES,
        infer_param_shardings,
        make_mesh,
        sequence_parallel_attention,
        shard_batch,
        shard_model_,
    )
    from pytorchvideo_tpu_torch.train import run_sharded_step
    from pytorchvideo_tpu_torch.transforms.mix import MixUp

    _patch_mix(inputs)
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    forwards = {}
    for name, case in inputs["forward_cases"].items():
        model = _mvit(case["config"], case["state_dict"]).eval()
        placements = infer_param_shardings(model, mesh, MEGATRON_ATTENTION_RULES)
        plan = shard_model_(model, placements, mesh)
        with torch.no_grad():
            forwards[name] = (plan.forward(model, shard_batch(inputs["forward_x"], mesh)),
                              len(plan.tensor_parallel), sorted(plan.region))
    out["forward"] = forwards

    steps = {}
    for name, case in inputs["step_cases"].items():
        build = _mvit if "spatial_size" in case["config"] else (
            lambda config, sd: _loaded(create_x3d(**config, device="cpu"), sd))
        model = build(case["config"], case["state_dict"]).train()
        steps[name] = _mesh_step(model, case, mesh)
    out["steps"] = steps

    sharded = {}
    for name, case in inputs["sharded_cases"].items():
        if name == "slowfast":
            model = _loaded(create_slowfast(**case["config"], device="cpu"), case["state_dict"])
            video = list(case["video"])
        else:
            model = _mvit(case["config"], case["state_dict"])
            video = case["video"]
        mix = MixUp(**case["mix"]) if case["mix"] else None
        result = run_sharded_step(model.train(), video, case["label"], mix, mesh=mesh)
        sharded[name] = (result.loss, result.plan.full_state_dict(model),
                         _momenta(model, result.state.optimizer, _shards(model, result.plan)),
                         {n: [str(p) for p in pl] for n, pl in result.plan.placements.items()})
    out["sharded"] = sharded

    q, k, v, heads, scale = inputs["sp_dp"]
    out["sp_dp"] = sequence_parallel_attention(q, k, v, heads, scale, mesh=mesh,
                                               batch_axis="data", kv_sharded=True)
    return out


def _loaded(model, state_dict):
    model.load_state_dict(state_dict, strict=True)
    return model


TASKS = {"primitives": primitives, "training": training, "tensor_parallel": tensor_parallel}
