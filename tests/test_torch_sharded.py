"""The sharded port on gloo ranks, held to the JAX package and to the
unsharded port.

Each case runs ``tests/_torch_sharded_ranks.py`` in a subprocess, which
spawns 8 gloo ranks (no process group ever starts in the pytest worker);
the reference's numbers are computed here, with JAX on the CPU and
``ctx=None``, its params carried over by ``convert.lm_params_from_jax``.

* the weighted federated step on a 2x2x2 (pod, data, model) mesh, reduced
  qwen2-7b in f32 (the reference's slow
  ``test_federated_step_weighted_aggregation``): against the manual
  weighted FedAvg of the scheduled silo's gradient and against the
  reference's unsharded step, params within 2e-5 (the reference's own
  check allows 3e-2), loss and gradient norm within 1e-5 relative;
* the expert-parallel MoE on data 4 x model 2, reduced qwen3-moe with
  capacity factor 8 (``test_moe_shard_map_matches_local``): against the
  reference's ``moe_ffn(ctx=None)``, y within 1e-4, aux within 1e-5;
* each family (dense TP, context-parallel, hybrid, rwkv6, recurrentgemma,
  MoE, VLM cross attention) on data 4 x model 2 by the production rules:
  logits within 1e-4 and loss within 1e-5 relative of the unsharded
  port's, and a train step's new params within 1e-4 of the unsharded
  step's, gradient norms within 1e-4 relative (rwkv6's differ by 1.1e-5
  relative: its f32 scan and decays round differently on a batch
  shard);
* a sharded prefill and four decode steps on data 4 x model 2, the cache
  at the decode rules' placements: context-parallel qwen2-7b (its cache
  length split over "model", and at batch 1 over "data" and "model") and
  tensor-parallel gemma3-27b (key heads over "model"; at batch 1 the
  length over "data"): each step's logits and the final cache's floats
  within 1e-4 of the unsharded port's, its slot positions equal;
* on a one-rank mesh (what the card runs), the sharded bf16 remat train
  step of five models and qwen2-7b's prefill and decode bitwise equal to
  the unsharded ones.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.fl import distributed as JD
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import convert

HERE = os.path.dirname(__file__)


def run_ranks(case, tmp, inputs=None, world=8):
    if inputs is not None:
        torch.save(inputs, os.path.join(tmp, "in.pt"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_sharded_ranks.py"),
         case, str(tmp), str(world)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    return torch.load(os.path.join(tmp, "out.pt"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def test_federated_step_weighted_aggregation(tmp_path):
    cfg = JC.get_config("qwen2-7b").reduced()
    params = JT.init(jax.random.key(0), cfg)
    B, S = 8, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    targets = rng.integers(0, cfg.vocab_size, (B, S))
    mask_silos = np.array([1.0, 0.0])           # only silo 0 scheduled
    w = np.repeat(mask_silos / mask_silos.sum() * 2, B // 2)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "targets": jnp.asarray(targets, jnp.int32),
              "schedule_weights": jnp.asarray(w, jnp.float32)}
    ref_new, ref_m = jax.jit(JD.make_train_step(cfg, None, eta=0.1,
                                                federated=True))(params,
                                                                 jbatch)

    def loss0(p):   # the scheduled silo's half of the batch only
        return JT.loss_fn(p, cfg, {"tokens": jbatch["tokens"][:4],
                                   "targets": jbatch["targets"][:4]})[0]
    g0 = jax.grad(loss0)(params)
    fedavg = jax.tree.map(lambda p, g: p - 0.1 * g, params, g0)

    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                         device="cpu")
    tbatch = {"tokens": torch.as_tensor(tokens),
              "targets": torch.as_tensor(targets),
              "schedule_weights": torch.as_tensor(w, dtype=torch.float32)}
    out = run_ranks("fed", tmp_path, {"params": tparams, "batch": tbatch})

    got = dict(_leaves(out["params"]))
    for name, want in (("reference step", ref_new), ("FedAvg", fedavg)):
        want = dict(_leaves(convert.lm_params_from_jax(
            jax.tree.map(np.asarray, want), device="cpu")))
        assert sorted(got) == sorted(want)
        err = max(float((got[k] - want[k]).abs().max()) for k in got)
        assert err < 2e-5, (name, err)
    m = out["metrics"]
    for k in ("loss", "grad_norm", "ce_loss"):
        ref = float(ref_m[k])
        assert abs(float(m[k]) - ref) <= 1e-5 * abs(ref), (k, m[k], ref)


def test_moe_shard_map_matches_local(tmp_path):
    import dataclasses
    cfg = dataclasses.replace(
        JC.get_config("qwen3-moe-235b-a22b").reduced(), capacity_factor=8.0)
    params = JM.moe_params_init(jax.random.key(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.key(1), (4, 8, cfg.d_model))
    y_local, aux_local = JM.moe_ffn(params, cfg, x, ctx=None)
    out = run_ranks("moe", tmp_path, {
        "params": convert.lm_params_from_jax(
            jax.tree.map(np.asarray, params), device="cpu"),
        "x": torch.as_tensor(np.array(x))})
    err = float((out["y"] - torch.as_tensor(np.asarray(y_local)))
                .abs().max())
    assert err < 1e-4, err
    assert abs(float(out["aux"]) - float(aux_local)) < 1e-5


def test_each_family_sharded_matches_unsharded(tmp_path):
    out = run_ranks("families", tmp_path)
    assert sorted(out) == sorted(["dense_tp", "context_parallel", "hybrid",
                                  "rwkv6", "recurrentgemma", "moe",
                                  "vlm_cross"])
    for name, r in out.items():
        err = float((r["logits"] - r["ref_logits"]).abs().max())
        assert err < 1e-4, (name, err)
        for k, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
            ref = float(r[f"ref_{k}"])
            assert abs(float(r[k]) - ref) <= tol * abs(ref), (name, k)
        assert abs(float(r["aux"]) - float(r["ref_aux"])) < 1e-6, name
        assert r["step_err"] < 1e-4, (name, r["step_err"])


def test_sharded_prefill_and_decode_match_unsharded(tmp_path):
    out = run_ranks("serve", tmp_path)
    # the stacked k [nper, B, n, KV, hd]: the dims the decode rules split
    split = {"context_parallel": [1, 2], "context_parallel_batch1": [2],
             "dense_tp": [1, 3], "dense_tp_batch1": [2, 3]}
    assert sorted(out) == sorted(split)
    for name, r in out.items():
        assert r["k_split_dims"] == split[name], (name, r["k_split_dims"])
        assert len(r["logit_errs"]) == 5, name       # prefill + 4 decodes
        assert max(r["logit_errs"]) < 1e-4, (name, r["logit_errs"])
        assert r["same_leaves"] and r["cache_ints_equal"], name
        assert r["cache_err"] < 1e-4, (name, r["cache_err"])


def test_world_size_one_is_bitwise_unsharded(tmp_path):
    """What the card checks at world size 1, on the CPU's plain versions:
    the sharded federated train step (bf16, remat) of each regime's
    model, and qwen2-7b's prefill and 8 decode steps, bitwise equal to
    the unsharded ones."""
    out = run_ranks("world_one", tmp_path, world=1)
    assert out == {k: True for k in out} and len(out) == 6, out


@pytest.fixture(autouse=True)
def _cpu_jax():
    assert jax.default_backend() == "cpu"
