"""The rank side of the production layout's tests
(``tests/test_torch_production.py``): the port's cache-free forward,
``grpo_loss`` with every gradient, ``build_train_step`` and the MoE
capacity dispatch on a gloo group of ranks, each rank handing back what
it saw (``rank{r}.pkl``).

Nothing here imports JAX: the ranks are fresh processes started by
``repro_torch.launch.mesh.spawn``, which import this module by name.
The test process writes the reference's weights and the inputs (numpy)
to ``inputs.pkl``; each rank cuts its pieces of the weights
(``launch.steps.param_shards``), runs every case on the CPU at f32 and
writes back whole tensors: logits, gradients and parameters gathered
from every rank's pieces (``launch.steps.gather_params``), the MoE
output's rank piece and its dispatch records."""
import pickle
from dataclasses import replace
from pathlib import Path

# arch keys of the model cases: (arch, config overrides)
MODEL_ARCHS = {"granite": ("granite-3-8b", {}),
               "moonshot": ("moonshot-v1-16b-a3b", {}),
               "vlm": ("llama-3.2-vision-11b", {}),
               "zamba2": ("zamba2-1.2b", {}),
               "whisper": ("whisper-tiny", {})}
TRAIN_STEP_ARCHS = ("granite", "moonshot")
TRAIN_STEPS = 2


def port_cfg(arch, overrides):
    from repro_torch.configs import get_tiny_config
    return replace(get_tiny_config(arch), dtype="float32", **overrides)


def _torch_batch(batch):
    import torch
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _masters(cfg, tree, sctx):
    """This rank's f32 pieces of the reference's weights, requiring
    gradients."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.launch.steps import param_shards
    from repro_torch.training.optim import tree_map
    whole = params_from_jax(cfg, tree, device="cpu", dtype="float32")
    return tree_map(lambda p: p.detach().clone().requires_grad_(),
                    param_shards(cfg, whole, sctx))


def _whole_numpy(cfg, shards, sctx):
    from repro_torch.bridge import params_to_numpy
    from repro_torch.launch.steps import gather_params
    return params_to_numpy(cfg, gather_params(cfg, shards, sctx))


def model_case(cfg, tree, batch, sctx):
    """Forward logits, ``grpo_loss``, its metrics and every gradient leaf
    (gathered, the reference's tree) under ``sctx``, and the MoE
    layers' drops."""
    import torch
    from repro_torch.bridge import to_numpy
    from repro_torch.models import moe
    from repro_torch.models.transformer import forward
    from repro_torch.training import grpo
    from repro_torch.training.optim import tree_items, tree_rebuild
    params = _masters(cfg, tree, sctx)
    tb = _torch_batch(batch)
    toks = tb["tokens"]
    B, S = toks.shape
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    aux = {k: v for k, v in tb.items()
           if k in ("image_embeds", "audio_frames")} or None
    with torch.no_grad():
        logits, _, _ = forward(cfg, params, toks, pos, aux_inputs=aux,
                               train=True, sctx=sctx)
    moe.DISPATCH_LOG = []
    loss, met = grpo.grpo_loss(cfg, params, tb, sctx=sctx)
    drops = sum(int((r["local"] & ~r["valid"]).sum())
                for r in moe.DISPATCH_LOG)
    moe.DISPATCH_LOG = None
    leaves = [t for _, t in tree_items(params)]
    grads = tree_rebuild(params, torch.autograd.grad(loss, leaves))
    return {"logits": to_numpy(logits), "loss": float(loss.detach()),
            "metrics": {k: float(v) for k, v in met.items()},
            "grads": _whole_numpy(cfg, grads, sctx), "drops": drops}


def train_case(cfg, tree, batches, sctx):
    """``build_train_step`` for ``len(batches)`` AdamW steps: losses,
    grad norms and the parameters after, gathered."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training.optim import init_opt_state
    params = _masters(cfg, tree, sctx)
    state = init_opt_state(params)
    step = build_train_step(cfg, sctx)
    losses, norms = [], []
    for batch in batches:
        params, state, loss, met = step(params, state, _torch_batch(batch))
        losses.append(float(loss))
        norms.append(float(met["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "params": _whole_numpy(cfg, params, sctx)}


def moe_case(case, sctx):
    """One MoE layer under the production context: the output's rank
    piece, aux, and each dispatch's records (numpy)."""
    import torch
    from repro_torch.bridge import params_from_jax, to_numpy
    from repro_torch.launch.steps import param_shards
    from repro_torch.models import moe
    cfg = port_cfg(case["arch"], case["overrides"])
    whole = params_from_jax(cfg, case["params"], device="cpu")
    block = param_shards(cfg, whole, sctx)["layers"][case["layer"]]["moe"]
    moe.DISPATCH_LOG = []
    with torch.no_grad():
        y, aux = moe.moe_forward(torch.from_numpy(case["x"]), block, cfg,
                                 sctx)
    recs = [{k: (to_numpy(v) if isinstance(v, torch.Tensor) else v)
             for k, v in r.items()} for r in moe.DISPATCH_LOG]
    moe.DISPATCH_LOG = None
    return {"y": to_numpy(y), "aux": float(aux), "records": recs}


def rank_main(rank, world, device, in_file, out_dir):
    """A rank of the tests' group: every case at tp = ``world``, written
    to ``out_dir/rank{rank}.pkl``."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_shard_ctx, small_mesh
    with open(in_file, "rb") as f:
        inp = pickle.load(f)
    train_ctx = make_shard_ctx(small_mesh(world), train=True)
    out = {"models": {}, "train": {}, "moe": {}, "traffic": {}}
    for key, (arch, over) in MODEL_ARCHS.items():
        cfg = port_cfg(arch, over)
        for sp in (True, False):
            sharding.reset_traffic()
            out["models"][key, sp] = model_case(
                cfg, inp["params"][key], inp["batches"][key],
                replace(train_ctx, seq_shard=sp))
            out["traffic"][key, sp] = dict(sharding.traffic)
    for key in TRAIN_STEP_ARCHS:
        cfg = port_cfg(*MODEL_ARCHS[key])
        out["train"][key] = train_case(cfg, inp["params"][key],
                                       inp["train_batches"][key], train_ctx)
    for name, case in inp["moe"].items():
        sctx = replace(train_ctx, seq_shard=case["seq_shard"],
                       axis_sizes=(("data", case["data"]),))
        out["moe"][name] = moe_case(case, sctx)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
