"""The port's training path against the JAX package's, on the CPU, f32
unless said, on the same weights (`lm.numpy_params`) and batches:

* `lm.forward_train_loss` and the gradient of every master leaf against
  `jax.value_and_grad` of the reference's `forward_train_loss` at the
  SMOKE configs of StarCoder2-3B, Qwen3-MoE (router, experts, dropped
  pairs) and DeepSeek-V2 (MLA at widths (24, 16), a leading dense
  layer): loss to rtol 1e-5, each gradient to rtol 1e-4 plus 1e-5 of
  its leaf's largest magnitude (sums in another order; the reference's
  CPU backend fuses multiply-adds, ROADMAP C1); remat on and off give
  the same numbers;
* `lm.lm_loss` (full logits, with and without a mask) at rtol 1e-6;
* three train steps of `launch.steps.make_train_step` against
  `jax.jit(repro.launch.steps.make_train_step)` (AdamW, f32 and bf16
  state): losses, grad norms, masters and moments; k = 2 microbatches;
* the counterparts of `tests/test_train_loop.py`'s `test_loss_decreases`
  and `test_checkpoint_restart_bitwise` (each a few seconds here), the
  coflow plan of the gradient buckets, what still raises (K7's (256,
  256)), Gemma-7B's and Chameleon-34B's SMOKE
  losses, and an import of the train path that loads no jax;
* the golden `chip_smoke.py` holds the card to
  (`tests/data/torch_port_train_starcoder2_golden.json`: StarCoder2-3B at
  its published width, 2 layers, f32, 3 AdamW steps of batch 2 x 128):
  a `slow` test regenerates it with the JAX package, another holds the
  port on the CPU to it (~8 GB of f32 masters, gradients and moments:
  run them alone, not under xdist).
"""
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.data import SyntheticLMData as JData
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models.common import Parallelism
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.launch import steps as ST
from repro_torch.launch.train import train
from repro_torch.models import lm
from repro_torch.optim import make_optimizer

ROOT = Path(__file__).resolve().parents[1]
ARCH = "starcoder2-3b"
ARCHS = [ARCH, "qwen3-moe-235b-a22b", "deepseek-v2-236b"]
PAR = Parallelism(None)
GOLDEN = ROOT / "tests" / "data" / "torch_port_train_starcoder2_golden.json"
GOLDEN_RUN = {"layers": 2, "batch": 2, "seq": 128, "steps": 3, "seed": 0}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The train loops run thousands of small ops. Beside the suite's
    other busy workers, torch's intra-op thread pool fights them for
    the cores and slows these tests about a hundredfold; on one thread
    they take about their time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, smoke=True, **fields):
    fields.setdefault("dtype", "float32")
    port = get_smoke_config(arch) if smoke else get_config(arch)
    ref = jget_smoke(arch) if smoke else jget_config(arch)
    return (dataclasses.replace(port, **fields),
            dataclasses.replace(ref, **fields))


def _batches(cfg, batch, seq, steps, seed=0):
    data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=seed)
    out = []
    for s in range(steps):
        t = data.arrays(s)["tokens"]
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _close(got, want, rtol, what, scale=0.0):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()),
                               err_msg=what)


def _port_batch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    cfg, jc = _configs(arch)
    params, meta = lm.numpy_params(cfg, seed=0)
    (b,) = _batches(cfg, 2, 48, 1, seed=1)
    masters = lm.masters_from_reference(params, cfg)
    loss = lm.forward_train_loss(lm.skeleton(cfg), masters, _port_batch(b))
    grads = torch.autograd.grad(loss, list(masters.values()))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train_loss(jc, p, meta, _jax_batch(b), PAR))(
            jax.tree.map(jnp.asarray, params))
    _close(loss, jloss, 1e-5, "loss")
    want = lm.reference_leaves(jax.tree.map(np.asarray, jgrads), cfg)
    assert list(want) == list(masters)
    for (n, w), g in zip(want.items(), grads):
        assert g.shape == w.shape, n
        _close(g, w, 1e-4, n, scale=1e-5)

    # remat recomputes the same numbers
    nore = lm.forward_train_loss(
        lm.skeleton(dataclasses.replace(cfg, remat="none")), masters,
        _port_batch(b))
    assert float(nore.detach()) == float(loss.detach())
    for g, h in zip(grads, torch.autograd.grad(nore,
                                               list(masters.values()))):
        assert torch.equal(g, h)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.uniform(size=(2, 9)) < 0.6).astype(np.float32) \
        if masked else None
    want = jlm.lm_loss(None, jnp.asarray(logits), jnp.asarray(targets),
                       None if mask is None else jnp.asarray(mask))
    got = lm.lm_loss(torch.tensor(logits), torch.tensor(targets),
                     None if mask is None else torch.tensor(mask))
    _close(got, want, 1e-6, "lm_loss")


def _three_steps(cfg, jc, batch, seq):
    params, meta = lm.numpy_params(cfg, seed=0)
    batches = _batches(cfg, batch, seq, 3)
    jopt = jmake_optimizer(jc, total_steps=3)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    jstep = jax.jit(jsteps.make_train_step(jc, meta, PAR, jopt))
    masters = lm.masters_from_reference(params, cfg)
    opt = make_optimizer(cfg, total_steps=3,
                         groups=lm.reference_groups(cfg))
    state = opt.init(masters)
    step_fn = ST.make_train_step(cfg, opt)
    for step, b in enumerate(batches):
        jp, js, jm = jstep(jp, js, jnp.int32(step), _jax_batch(b))
        masters, state, m = step_fn(masters, state, step, _port_batch(b))
        _close(m["loss"], jm["loss"], 1e-5, f"loss at step {step}")
        _close(m["grad_norm"], jm["grad_norm"], 1e-5,
               f"grad_norm at step {step}")
        assert m["step"] == step + 1
    return masters, state, jp, js


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
def test_three_train_steps_match_jax(arch):
    """StarCoder2 keeps f32 moments, Qwen3-MoE bf16 ones
    (`opt_state_dtype`)."""
    cfg, jc = _configs(arch)
    masters, state, jp, js = _three_steps(cfg, jc, 2, 32)
    bf16 = cfg.opt_state_dtype == "bfloat16"
    sdt = torch.bfloat16 if bf16 else torch.float32
    # a bf16 moment may round one way here and the other there (held to
    # one bf16 step of its leaf's largest magnitude), which moves that
    # element's update by up to 2^-8 of itself (a leaf that started at
    # zero holds nothing but updates)
    scale, rtol = (1e-4, 2.0 ** -7) if bf16 else (1e-5, 1e-5)
    mscale = 2.0 ** -8 if bf16 else 1e-5
    want = lm.reference_leaves(jax.tree.map(np.asarray, jp), cfg)
    for n, w in want.items():
        _close(masters[n], w, 1e-5, n, scale=scale)
    for k in ("m", "v"):
        ref = lm.reference_leaves(
            jax.tree.map(lambda a: np.asarray(a, np.float32), js[k]), cfg)
        for n, w in ref.items():
            assert state[k][n].dtype == sdt
            _close(state[k][n], w, rtol, f"{k} of {n}", scale=mscale)


def test_microbatches_accumulate_as_the_reference():
    cfg, jc = _configs(ARCH, train_microbatches=2)
    masters, _, jp, _ = _three_steps(cfg, jc, 4, 32)
    want = lm.reference_leaves(jax.tree.map(np.asarray, jp), cfg)
    for n, w in want.items():
        _close(masters[n], w, 1e-5, n, scale=1e-5)


def test_loss_decreases():
    out = train(ARCH, steps=30, smoke=True, batch=4, seq=64, device="cpu",
                ckpt_dir=None, log_every=1000, coflow_plan=False)
    losses = out["losses"]
    assert len(losses) == 30 and out["final_step"] == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_checkpoint_restart_bitwise(tmp_path):
    """Crash and resume replays the uninterrupted run: 20 steps with a
    checkpoint every 6, the one at 18 lost, resume from 12."""
    d = str(tmp_path / "ckpt")
    kw = dict(steps=20, smoke=True, batch=4, seq=64, ckpt_dir=d,
              ckpt_every=6, log_every=1000, coflow_plan=False, device="cpu")
    full = train(ARCH, **kw)
    assert latest_step(d) == 18
    shutil.rmtree(f"{d}/step_{18:08d}")   # the crash
    assert latest_step(d) == 12
    resumed = train(ARCH, **kw)
    assert resumed["final_step"] == 20
    np.testing.assert_allclose(resumed["losses"], full["losses"][12:],
                               rtol=1e-6)


def test_coflow_plan_covers_every_gradient_bucket(monkeypatch):
    import repro_torch.launch.train as T
    from repro_torch.runtime.buckets import bucketize
    from repro_torch.runtime.coflow_bridge import (grad_bucket_coflows,
                                                   plan_waves)

    cfg = dataclasses.replace(get_smoke_config(ARCH), d_model=256, d_ff=512,
                              vocab_size=4096)
    monkeypatch.setattr(T, "get_smoke_config", lambda arch: cfg)
    out = train(ARCH, steps=1, batch=2, seq=16, device="cpu",
                log_every=1000)
    bks = bucketize(lm.init_masters(cfg), bucket_bytes=8 * 1024 * 1024)
    names = sorted(n for w in out["plan"] for n in w)
    assert names == sorted(f"grad/{b.bid}" for b in bks)
    assert out["plan"] == plan_waves(grad_bucket_coflows(bks), num_chips=8,
                                     backend="numpy", device="cpu")
    assert not any(out["plan_launches"].values())   # plain versions


def test_archs_not_served_yet_raise():
    """What training still lacks (ROADMAP queue A item 11e-ii): K7
    refuses Gemma-7B's (256, 256) heads before it looks at the device."""
    q = torch.zeros(1, 2, 8, 256)
    with pytest.raises(ValueError, match="11e-ii"):
        flash_attention_bwd_cuda(q, q, q, q, q)


@pytest.mark.parametrize("arch", ["gemma-7b", "chameleon-34b"])
def test_dense_smoke_losses_match_jax(arch):
    """Gemma-7B (tied and scaled embeddings, GeGLU, head_dim 32 at SMOKE)
    and Chameleon-34B (qk-norm) SMOKE losses against the reference's
    `forward_train_loss` at the train golden's bar (rtol 1e-5), f32 and
    in the config's bf16 (rtol 2e-2, one bf16 rounding of the loss's
    terms)."""
    for dtype, rtol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        cfg, jc = _configs(arch, dtype=dtype)
        params, meta = lm.numpy_params(cfg, seed=0)
        (b,) = _batches(cfg, 2, 48, 1, seed=1)
        masters = lm.masters_from_reference(params, cfg)
        loss = lm.forward_train_loss(lm.skeleton(cfg), masters,
                                     _port_batch(b))
        jloss = jlm.forward_train_loss(jc, jax.tree.map(jnp.asarray, params),
                                       meta, _jax_batch(b), PAR)
        _close(loss, jloss, rtol, f"{arch} {dtype} loss")


def test_train_path_imports_no_jax():
    code = ("import sys, repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.data, repro_torch.checkpoint; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---- the full-width golden ------------------------------------------------

def _golden_configs():
    return _configs(ARCH, smoke=False, num_layers=GOLDEN_RUN["layers"])


@pytest.mark.slow
def test_regenerate_train_golden():
    cfg, jc = _golden_configs()
    params, meta = lm.numpy_params(cfg, seed=GOLDEN_RUN["seed"])
    jopt = jmake_optimizer(jc, total_steps=GOLDEN_RUN["steps"])
    jp = jax.tree.map(jnp.asarray, params)
    del params
    js = jopt.init(jp)
    step_fn = jax.jit(jsteps.make_train_step(jc, meta, PAR, jopt),
                      donate_argnums=(0, 1))
    data = JData(jc.vocab_size, GOLDEN_RUN["seq"], GOLDEN_RUN["batch"],
                 seed=GOLDEN_RUN["seed"])
    losses, gnorms = [], []
    for step in range(GOLDEN_RUN["steps"]):
        t = data.batch(step)["tokens"]
        jp, js, m = step_fn(jp, js, jnp.int32(step),
                            {"tokens": t[:, :-1], "labels": t[:, 1:]})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    leaves = lm.reference_leaves(jax.tree.map(np.asarray, jp), cfg)
    gold = {
        "description": "StarCoder2-3B at its published width, depth cut to "
                       "2 layers, f32: the reference for chip_smoke.py's "
                       "train golden (phase 29)",
        "call": "jax.jit(repro.launch.steps.make_train_step) (CPU) with "
                "repro.optim.make_optimizer(cfg, total_steps=3) (AdamW) on "
                "repro_torch.models.lm.numpy_params(cfg, seed=0), batches "
                "of repro.data.SyntheticLMData(vocab, seq, batch, seed=0), "
                "tokens[:, :-1] against tokens[:, 1:]",
        "platform": "cpu",
        "jax": jax.__version__,
        "regenerate": "PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q "
                      "-m slow tests/test_torch_train.py -k "
                      "regenerate_train_golden",
        "config_cuts": {"num_layers": GOLDEN_RUN["layers"],
                        "dtype": "float32"},
        **GOLDEN_RUN,
        "losses": losses,
        "grad_norms": gnorms,
        "leaf_norms": {n: float(np.linalg.norm(np.asarray(a, np.float64)))
                       for n, a in leaves.items()},
    }
    GOLDEN.write_text(json.dumps(gold, indent=1) + "\n")


@pytest.mark.slow
def test_port_holds_the_train_golden_on_the_cpu():
    gold = json.loads(GOLDEN.read_text())
    cfg, _ = _golden_configs()
    params, _ = lm.numpy_params(cfg, seed=gold["seed"])
    masters = lm.masters_from_reference(params, cfg)
    del params
    opt = make_optimizer(cfg, total_steps=gold["steps"])
    state = opt.init(masters)
    step_fn = ST.make_train_step(cfg, opt)
    for step, b in enumerate(_batches(cfg, gold["batch"], gold["seq"],
                                      gold["steps"], seed=gold["seed"])):
        masters, state, m = step_fn(masters, state, step, _port_batch(b))
        _close(m["loss"], gold["losses"][step], 1e-5, f"loss {step}")
        _close(m["grad_norm"], gold["grad_norms"][step], 1e-4,
               f"grad_norm {step}")
    assert sorted(gold["leaf_norms"]) == sorted(masters)
    for n, t in masters.items():
        got = float(torch.linalg.vector_norm(t.detach().double()))
        _close(got, gold["leaf_norms"][n], 1e-5, n)
