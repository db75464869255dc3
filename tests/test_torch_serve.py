"""The port's serving CLI (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``) on the same flags, on the CPU.

Both serve the tiny config in its default bf16 from weights of their own
seeded init, so the plain run holds the reports' keys, requests and
tokens.  The exact run swaps, in the test only, both packages'
``get_tiny_config`` for the f32 variant and the port's ``init_params``
for the reference's weights of the same seed (through the bridge): then
the reports are equal field for field, the wall time and rate left
out."""
import json
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
import repro_torch.models as tmodels
from repro.launch import serve as jserve
from repro.models import init_params as jinit_params
from repro_torch.bridge import params_from_jax
from repro_torch.launch import serve

torch.set_num_threads(2)
FLAGS = ["--groups", "2", "--group-size", "3", "--max-new-tokens", "12",
         "--slots", "2", "--cache-len", "64", "--chunk", "8"]
TIMING = ("wall_seconds", "tokens_per_sec")


def _run_both(tmp_path, flags):
    jserve.main(flags + ["--out", str(tmp_path / "ref.json")])
    got = serve.main(flags + ["--device", "cpu",
                              "--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "ref.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads(json.dumps(got))
    return want, got


def test_serve_reports_like_the_reference(tmp_path):
    want, got = _run_both(tmp_path, FLAGS)
    assert got["arch"] == want["arch"] == "yi-6b"
    assert sorted(got) == sorted(want)
    for k in ("pool", "dgds", "ctx"):
        assert sorted(got[k]) == sorted(want[k]), k
    assert got["requests"] == want["requests"] == 6
    assert got["tokens"] == want["tokens"] == 6 * 12


@pytest.mark.parametrize("arch", ["yi-6b", "moonshot-v1-16b-a3b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_serve_f32_equals_the_reference(tmp_path, monkeypatch, arch):
    jget, tget = jcfgs.get_tiny_config, tcfgs.get_tiny_config
    monkeypatch.setattr(jcfgs, "get_tiny_config",
                        lambda a: replace(jget(a), dtype="float32"))
    monkeypatch.setattr(tcfgs, "get_tiny_config",
                        lambda a: replace(tget(a), dtype="float32"))

    def reference_weights(cfg, generator, device=None):
        jcfg = jcfgs.get_tiny_config(arch)
        jp, _ = jinit_params(jcfg, jax.random.PRNGKey(
            generator.initial_seed()))
        return params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                               device=device)
    monkeypatch.setattr(tmodels, "init_params", reference_weights)
    want, got = _run_both(tmp_path, FLAGS + ["--arch", arch, "--seed", "2"])
    for k in TIMING:
        want.pop(k)
        got.pop(k)
    assert json.loads(json.dumps(got)) == want
    # requests ran in chunks through the KV pool, and drafts were verified
    assert want["chunks"] > want["requests"] and want["pool"]["puts"] > 0
    assert want["drafted"] > 0
