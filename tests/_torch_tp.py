"""The workloads of the port's tensor-parallel tests
(``tests/test_torch_tp.py``), written against a namespace of names so
that the same code drives the JAX package (``tp=None``, the oracle) and
the port's ranks, and the entry point of those ranks (:func:`rank_main`).

Nothing here imports JAX: the ranks are fresh processes started by
``repro_torch.launch.mesh.spawn``, which import this module by name.
Each rank loads the reference's weights (numpy, written by the test
process), runs every case at ``tp=None``, ``tp=1`` and ``tp=k`` on the
CPU (f32, one thread) and writes what it saw to ``rank{r}.pkl``: tokens,
logprobs, engine steps, host syncs per step, blob headers and bytes,
rollout counters and its lockstep digests.  The test process compares
them with the reference's run and across ranks."""
import pickle
import types
from dataclasses import replace
from pathlib import Path

import numpy as np

# dense, GQA under the head guard (yi 4/1, phi4 3/1), MoE, SSM, hybrid,
# VLM and audio (tiny configs; whisper's and phi4's 3 heads stay whole at
# tp = 2)
ARCHS = ["granite-3-8b", "yi-6b", "phi4-mini-3.8b", "moonshot-v1-16b-a3b",
         "mixtral-8x7b", "mamba2-370m", "zamba2-1.2b",
         "llama-3.2-vision-11b", "whisper-tiny"]
TREE_ARCHS = ["granite-3-8b", "llama-3.2-vision-11b"]
MIGRATE_ARCHS = ["granite-3-8b", "zamba2-1.2b"]
PAIR_SLOTS = 2
ROLLOUT = dict(n_instances=2, max_slots=2, cache_len=128, chunk_size=8,
               policy="seer", spec_decode=True, prefill_chunk=4)
ROLLOUT_PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [5, 9, 2, 6, 5, 3],
                   [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]]


def embeds(cfg, seed=0):
    """Seeded random modality embeddings for a VLM or audio model's
    slots (the zero stub would make every cross K/V 0), or None."""
    if cfg.arch_type not in ("vlm", "audio"):
        return None
    n = cfg.num_image_tokens if cfg.arch_type == "vlm" \
        else cfg.num_audio_frames
    rng = np.random.default_rng(seed)
    return rng.normal(size=(PAIR_SLOTS, n, cfg.d_model)).astype(np.float32)


def _inst(api, cfg, params, steps, tp, **kw):
    kw = dict(max_slots=PAIR_SLOTS, cache_len=128, prefill_chunk=8,
              base_seed=7, **kw)
    e = embeds(cfg)
    if e is not None:
        kw["modality_embeds"] = api.tensor(e)
    if tp is not None:
        kw["tp"] = tp
    return api.Instance(cfg, params, steps, **api.inst_kw, **kw)


def _seq(api, rid, prompt, n, seed=3):
    return api.EngineSeq(rid, "g0", list(prompt), seed=seed,
                         temperature=1.0, max_new_tokens=n)


def run_pair(api, cfg, params, steps, tp, n_new=10, gamma_max=4):
    """Two sequences, linear drafts for the first every other step
    (``tests/test_tp_engine.py``'s ``_run_pair``): tokens, logprobs,
    host syncs of each step, engine steps, and the instance's lockstep
    record (None for the reference)."""
    inst = _inst(api, cfg, params, steps, tp, gamma_max=gamma_max)
    s0 = _seq(api, "r0", [2, 3, 4, 5, 6, 7], n_new, seed=3)
    s1 = _seq(api, "r1", [5, 9, 2], n_new, seed=4)
    slot0 = inst.admit(s0)
    inst.admit(s1)
    syncs = []
    it = 0
    while not (s0.finished and s1.finished):
        drafts = {slot0: [(s0.generated[-1] + 13) % cfg.vocab_size] * 2} \
            if (s0.generated and not s0.finished and it % 2) else {}
        before = steps.host_syncs
        inst.run_step(drafts)
        syncs.append(steps.host_syncs - before)
        it += 1
        assert it < 200
    return {"tokens": [list(s0.generated), list(s1.generated)],
            "logprobs": [list(s0.logprobs), list(s1.logprobs)],
            "syncs": syncs, "steps": it, "lockstep": _lockstep(inst)}


def _lockstep(inst):
    return (getattr(inst, "lockstep_checks", None),
            getattr(inst, "lockstep_digest", None))


def run_tree(api, cfg, params, steps, tp, oracle=None, drafts="none"):
    """One sequence through the tree engine (``spec_mode="tree"``) with
    branching trees (a garbage trunk and the oracle's tokens as a side
    branch), oracle chains or no drafts; ``oracle`` None: the linear
    run that makes the oracle."""
    inst = _inst(api, cfg, params, steps, tp, gamma_max=4,
                 spec_mode="linear" if oracle is None else "tree")
    seq = _seq(api, "r0", list(range(2, 14)), 12)
    slot = inst.admit(seq)
    i = 0
    while not seq.finished:
        d = {}
        if oracle is not None and not seq.prefilling \
                and inst.decode_slots():
            k = len(seq.generated)
            if drafts == "tree" and oracle[k:k + 2]:
                good = list(oracle[k:k + 2])
                bad = [(x + 7) % cfg.vocab_size for x in good]
                d = {slot: api.build_token_tree([bad, good])}
            elif drafts == "chain" and oracle[k:k + 3]:
                d = {slot: api.chain_tree(list(oracle[k:k + 3]))}
        inst.run_step(d)
        i += 1
        assert i < 500
    return {"tokens": list(seq.generated), "steps": i,
            "lockstep": _lockstep(inst)}


def export_after(api, cfg, params, steps, tp, n_steps=6):
    """A request's KV blob after ``n_steps`` plain steps: its header,
    nbytes, CRC and arrays (numpy)."""
    inst = _inst(api, cfg, params, steps, tp, gamma_max=0,
                 instance_id=f"tp{tp}")
    seq = _seq(api, "r0", list(range(2, 14)), 16, seed=1)
    slot = inst.admit(seq)
    for _ in range(n_steps):
        inst.run_step()
    blob = inst.release(slot, export=True)
    return {"generated": list(seq.generated), "next_pos": blob.next_pos,
            "nbytes": blob.nbytes, "crc": blob.header_crc(),
            "arrays": {k: api.numpy(v) for k, v in blob.arrays.items()},
            "shapes": {k: tuple(v.shape) for k, v in blob.arrays.items()},
            "dtypes": {k: str(v.dtype).replace("torch.", "")
                       for k, v in blob.arrays.items()}}


def migrate(api, cfg, params, steps, hops):
    """One request hopping across instances of the tp degrees ``hops``
    (four steps on each, a checksummed blob between them): tokens and
    the prefill tokens of every import (0: a blob hit)."""
    seq = _seq(api, "r0", list(range(2, 16)), 16, seed=1)
    inst = _inst(api, cfg, params, steps, hops[0], gamma_max=0,
                 instance_id="hop0")
    slot = inst.admit(seq)
    prefills = []
    for hop, tp in enumerate(hops[1:], start=1):
        for _ in range(4):
            if seq.finished:
                break
            inst.run_step()
        if seq.finished:
            break
        blob = inst.release(slot, export=True).stamp_checksum()
        inst = _inst(api, cfg, params, steps, tp, gamma_max=0,
                     instance_id=f"hop{hop}")
        slot = inst.admit(seq, blob)
        prefills.append(inst.prefill_tokens)
    while not seq.finished:
        inst.run_step()
    return {"tokens": list(seq.generated), "prefills": prefills}


def _prompts(cfg, n_groups=3):
    return [[(7 * g + 3 * j) % (cfg.vocab_size - 2) + 1
             for j in range(6 + 4 * g)] for g in range(n_groups)]


def fault_run(api, cfg, params, steps, tp=None, tick=None, lose_pool=False):
    """``tests/test_faults.py``'s rollout (two instances, chunks of 5,
    plain decode), with inst0 crashed at ``tick`` when given."""
    inj = None
    if tick is not None:
        inj = api.FaultInjector([api.FaultEvent(
            tick=tick, kind="crash", instance_id="inst0",
            lose_pool=lose_pool)])
    kw = dict(n_instances=2, max_slots=2, cache_len=64, chunk_size=5,
              prefill_chunk=8, policy="seer", spec_decode=False,
              gamma_max=8, base_seed=7, watchdog_ticks=3, fetch_retries=3,
              fault_injector=inj, steps=steps)
    if tp is not None:
        kw["tp"] = tp
    ro = api.SeerRollout(cfg, params, **api.inst_kw, **kw)
    res = ro.run(api.make_groups(_prompts(cfg), group_size=2,
                                 max_new_tokens=12, seed=5))
    st = res.stats
    return {"responses": res.responses(), "ticks": st.ticks,
            "crashes": st.instance_crashes,
            "recovered": st.recovered_requests,
            "via_blob": st.recovered_via_blob,
            "via_replay": st.recovered_via_replay,
            "lockstep": [_lockstep(i) for i in ro.instances]}


def rollout_run(api, cfg, params, tp=None):
    """``tests/test_torch_rollout.py``'s rollout (grouped speculation,
    migrations through the pool) at temperature 1: responses, every
    ``RolloutStats`` counter but the wall clock, host syncs and the step
    kinds run."""
    kw = dict(ROLLOUT)
    if tp is not None:
        kw["tp"] = tp
    ro = api.SeerRollout(cfg, params, **api.inst_kw, **kw)
    res = ro.run(api.make_groups(ROLLOUT_PROMPTS, group_size=2,
                                 max_new_tokens=24, seed=5,
                                 temperature=1.0))
    stats = res.stats.snapshot()
    stats.pop("wall_seconds")
    return {"responses": res.responses(), "stats": stats,
            "host_syncs": ro.steps.host_syncs,
            "kinds": dict(ro.steps.invocations_by_kind),
            "lockstep": [_lockstep(i) for i in ro.instances]}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def port_api():
    """The port's names for the workloads above (CPU, f32)."""
    import torch

    from repro_torch.bridge import to_numpy
    from repro_torch.core import SeerRollout, make_groups
    from repro_torch.core.faults import FaultEvent, FaultInjector
    from repro_torch.engine import (EngineSeq, Instance, StepFunctions,
                                    build_token_tree, chain_tree)
    return types.SimpleNamespace(
        Instance=Instance, EngineSeq=EngineSeq, StepFunctions=StepFunctions,
        SeerRollout=SeerRollout, make_groups=make_groups,
        FaultInjector=FaultInjector, FaultEvent=FaultEvent,
        build_token_tree=build_token_tree, chain_tree=chain_tree,
        inst_kw={"device": "cpu"}, tensor=torch.from_numpy, numpy=to_numpy)


def port_models(params_file):
    """arch -> (port cfg at f32, the reference's weights in the port)."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_tiny_config
    with open(params_file, "rb") as f:
        trees = pickle.load(f)
    out = {}
    for arch, tree in trees.items():
        cfg = replace(get_tiny_config(arch), dtype="float32")
        out[arch] = (cfg, params_from_jax(cfg, tree, device="cpu"))
    return out


def rank_cases(api, models, tp):
    """Every case of one rank at degree ``tp`` (and the tp=None / tp=1
    runs it is held to)."""
    out = {"pair": {}, "tree": {}, "migrate": {}}
    for arch, (cfg, params) in models.items():
        steps = api.StepFunctions(cfg)
        runs = {}
        for t in (None, 1, tp):
            runs[t] = {"linear": run_pair(api, cfg, params, steps, t),
                       "plain": run_pair(api, cfg, params, steps, t,
                                         gamma_max=0)}
        out["pair"][arch] = runs
        if tp != 2:
            continue
        if arch in TREE_ARCHS:
            oracle = run_tree(api, cfg, params, steps, None)["tokens"]
            out["tree"][arch] = {
                d: run_tree(api, cfg, params, steps, tp, oracle, d)
                for d in ("tree", "chain", "none")}
        if arch in MIGRATE_ARCHS:
            out["migrate"][arch] = {
                "oracle": migrate(api, cfg, params, steps, [None]),
                "hopped": migrate(api, cfg, params, steps,
                                  [tp, 1, tp, None])}
        if arch == "granite-3-8b":
            out["blob"] = {t: export_after(api, cfg, params, steps, t)
                           for t in (None, 1, tp)}
            nofault = fault_run(api, cfg, params, steps, tp)
            ticks = sorted({2, nofault["ticks"] // 2})
            out["faults"] = {
                "nofault": nofault,
                "cases": [(t, lp, fault_run(api, cfg, params, steps, tp,
                                            t, lp))
                          for t, lp in [(t, False) for t in ticks]
                          + [(ticks[-1], True)]]}
            out["rollout"] = {t: rollout_run(api, cfg, params, t)
                              for t in (None, tp)}
    return out


def rank_main(rank, world, device, params_file, out_dir):
    """A rank of the tests' group: every case at tp = world, written to
    ``out_dir/rank{rank}.pkl``."""
    from repro_torch import sharding
    api = port_api()
    models = port_models(params_file)
    sharding.reset_traffic()
    out = rank_cases(api, models, world)
    out["traffic"] = dict(sharding.traffic)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
