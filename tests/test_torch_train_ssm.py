"""Training through the Mamba mixer and the encoder, on the CPU, f32
unless said, against the JAX package on the same weights
(`lm.numpy_params`) and batches:

* `lm.forward_train_loss` and the gradient of every master leaf against
  `jax.value_and_grad` of the reference's `forward_train_loss` at the
  SMOKE configs of Mamba2-1.3B (the SSD scan through `mamba.SSDScan`:
  K4 forward, K8 backward on the card, the plain versions here),
  Jamba-v0.1-52B (seven Mamba mixers, a GQA layer, MoE) and the
  encoder-decoder SeamlessM4T-medium (encoder, `ln_enc`, the cross k
  and v of each decoder layer): loss to rtol 1e-5, each gradient to
  rtol 1e-4 plus 1e-5 of its leaf's largest magnitude. Jamba's eight
  layers compound the two packages' rounding (the reference's CPU
  backend fuses multiply-adds, ROADMAP C1) to 1.3e-4 of the largest
  at layer 0's d_skip, with the port's backward replaced by autograd
  through its plain forward too: its parity bar is rtol 1e-4 plus 2e-4
  of the largest, and its written-out backward is held at the tight
  bar to autograd through the port's own forward instead. Remat on and
  off give the same bits;
* three train steps of `launch.steps.make_train_step` against the
  reference's jitted step (AdamW): Mamba2 and SeamlessM4T (two
  microbatches: `src_embeds` splits with the tokens);
* `train(arch, steps=3, device="cpu")` for each of the three;
* the goldens `chip_smoke.py` phase 31 holds the card to
  (`tests/data/torch_port_train_mamba2_golden.json`: Mamba2-1.3B at its
  published width, 2 layers, f32, 3 AdamW steps of batch 2 x 256, two
  chunks a row; `torch_port_train_seamless_golden.json`:
  SeamlessM4T-medium at its published width, 2 + 2 layers, 3 steps of 4
  x 128 tokens, its 4 microbatches of one row, against 32 source frames):
  `slow` tests regenerate them
  with the JAX package, others hold the port on the CPU to them (run
  them alone, not under xdist: several GB of f32 masters and moments).
"""
import dataclasses
import json
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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.kernels.ref import ssd_chunked_ref
from repro_torch.launch import steps as ST
from repro_torch.launch.train import train
from repro_torch.models import lm, mamba
from repro_torch.optim import make_optimizer

ROOT = Path(__file__).resolve().parents[1]
MAMBA, JAMBA, SEAM = "mamba2-1.3b", "jamba-v0.1-52b", "seamless-m4t-medium"
ARCHS = [MAMBA, JAMBA, SEAM]
PAR = Parallelism(None)
SRC_LEN = 32   # the source frames a row `train` draws (the reference's)
# {arch: (rtol, share of the leaf's largest magnitude)}: the parity bars
GRAD_BARS = {MAMBA: (1e-4, 1e-5), JAMBA: (1e-4, 2e-4), SEAM: (1e-4, 1e-5)}
GOLDENS = {
    MAMBA: (ROOT / "tests" / "data" / "torch_port_train_mamba2_golden.json",
            {"layers": 2, "batch": 2, "seq": 256, "steps": 3, "seed": 0}),
    # the published config's 4 microbatches take a batch of 4 rows
    SEAM: (ROOT / "tests" / "data" / "torch_port_train_seamless_golden.json",
           {"layers": 2, "batch": 4, "seq": 128, "steps": 3, "seed": 0}),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """As in tests/test_torch_train.py: beside the suite's other busy
    workers torch's intra-op pool slows these loops a hundredfold."""
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
    data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=seed,
                           src_len=SRC_LEN if cfg.enc_dec else 0,
                           d_model=cfg.d_model)
    out = []
    for s in range(steps):
        a = data.arrays(s)
        b = {"tokens": a["tokens"][:, :-1], "labels": a["tokens"][:, 1:]}
        if cfg.enc_dec:
            b["src_embeds"] = a["src_embeds"]
        out.append(b)
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


def _loss_and_grads(cfg, masters, b):
    loss = lm.forward_train_loss(lm.skeleton(cfg), masters, _port_batch(b))
    return loss, torch.autograd.grad(loss, list(masters.values()))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    cfg, jc = _configs(arch)
    params, meta = lm.numpy_params(cfg, seed=0)
    (b,) = _batches(cfg, 2, 48, 1, seed=1)
    masters = lm.masters_from_reference(params, cfg)
    loss, grads = _loss_and_grads(cfg, masters, b)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train_loss(jc, p, meta, _jax_batch(b), PAR))(
            jax.tree.map(jnp.asarray, params))
    _close(loss, jloss, 1e-5, "loss")
    want = lm.reference_leaves(jax.tree.map(np.asarray, jgrads), cfg)
    assert list(want) == list(masters)
    rtol, scale = GRAD_BARS[arch]
    for (n, w), g in zip(want.items(), grads):
        assert g.shape == w.shape, n
        _close(g, w, rtol, n, scale=scale)

    # remat recomputes the same numbers
    nore, ngrads = _loss_and_grads(dataclasses.replace(cfg, remat="none"),
                                   masters, b)
    assert float(nore.detach()) == float(loss.detach())
    for g, h in zip(grads, ngrads):
        assert torch.equal(g, h)


def test_jamba_backward_matches_autograd_through_the_plain_forward(
        monkeypatch):
    """Jamba's SMOKE gradients through `SSDScan` (the written-out
    backward) against autograd through the port's plain forward
    `ssd_chunked_ref`, at the tight bar (rtol 1e-4 plus 1e-5 of each
    leaf's largest)."""
    cfg, _ = _configs(JAMBA)
    params, _ = lm.numpy_params(cfg, seed=0)
    (b,) = _batches(cfg, 2, 48, 1, seed=1)
    masters = lm.masters_from_reference(params, cfg)
    _, grads = _loss_and_grads(cfg, masters, b)
    monkeypatch.setattr(mamba, "scan", lambda x, dt, a, b, c, **kw:
                        ssd_chunked_ref(x, dt, a, b, c, lc=mamba.CHUNK))
    _, want = _loss_and_grads(cfg, masters, b)
    for n, g, w in zip(masters, grads, want):
        _close(g, w, 1e-4, n, scale=1e-5)


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
    return masters, jp


@pytest.mark.parametrize("arch,microbatches", [(MAMBA, 1), (SEAM, 2)])
def test_three_train_steps_match_jax(arch, microbatches):
    """Losses and grad norms at each step (above), then every master
    leaf's norm at the goldens' bar (rtol 1e-5): a leaf that starts at
    zero holds nothing but AdamW updates, whose elements with a
    near-zero gradient are no tighter than the gradient's rounding."""
    cfg, jc = _configs(arch, train_microbatches=microbatches)
    masters, jp = _three_steps(cfg, jc, 4, 32)
    want = lm.reference_leaves(jax.tree.map(np.asarray, jp), cfg)
    for n, w in want.items():
        _close(torch.linalg.vector_norm(masters[n].detach().double()),
               np.linalg.norm(np.asarray(w, np.float64)), 1e-5, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_runs(arch):
    out = train(arch, steps=3, device="cpu", batch=2, seq=32,
                log_every=1000, coflow_plan=False)
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    assert np.isfinite(out["grad_norms"]).all()


def test_train_takes_config_cuts(monkeypatch):
    """`config_cuts` replaces fields of the config that `train` builds
    (the card's Jamba run cuts its experts so)."""
    import repro_torch.launch.train as T

    seen, draw = [], T.lm.init_masters
    monkeypatch.setattr(T.lm, "init_masters",
                        lambda cfg, **kw: seen.append(cfg) or draw(cfg, **kw))
    out = train(JAMBA, steps=1, device="cpu", batch=2, seq=16,
                log_every=1000, coflow_plan=True,
                config_cuts={"num_experts": 2})
    assert [c.num_experts for c in seen] == [2]
    assert seen[0].num_layers == get_smoke_config(JAMBA).num_layers
    assert out["plan"] and np.isfinite(out["losses"]).all()


# ---- the full-width goldens ------------------------------------------------

def _golden_configs(arch):
    run = GOLDENS[arch][1]
    cuts = {"num_layers": run["layers"]}
    if get_config(arch).enc_dec:
        cuts["enc_layers"] = run["layers"]
    return _configs(arch, smoke=False, **cuts), cuts


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(GOLDENS))
def test_regenerate_train_golden(arch):
    path, run = GOLDENS[arch]
    (cfg, jc), cuts = _golden_configs(arch)
    params, meta = lm.numpy_params(cfg, seed=run["seed"])
    jopt = jmake_optimizer(jc, total_steps=run["steps"])
    jp = jax.tree.map(jnp.asarray, params)
    del params
    js = jopt.init(jp)
    step_fn = jax.jit(jsteps.make_train_step(jc, meta, PAR, jopt),
                      donate_argnums=(0, 1))
    src = SRC_LEN if cfg.enc_dec else 0
    data = JData(jc.vocab_size, run["seq"], run["batch"], seed=run["seed"],
                 src_len=src, d_model=cfg.d_model)
    losses, gnorms = [], []
    for step in range(run["steps"]):
        a = data.batch(step)
        b = {"tokens": a["tokens"][:, :-1], "labels": a["tokens"][:, 1:]}
        if src:
            b["src_embeds"] = a["src_embeds"]
        jp, js, m = step_fn(jp, js, jnp.int32(step), b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    leaves = lm.reference_leaves(jax.tree.map(np.asarray, jp), cfg)
    depth = (f"{run['layers']} + {run['layers']} layers" if src
             else f"{run['layers']} layers")
    gold = {
        "description": f"{cfg.name} at its published width, depth cut to "
                       f"{depth}, f32: the reference for chip_smoke.py's "
                       f"train golden (phase 31)",
        "call": "jax.jit(repro.launch.steps.make_train_step) (CPU) with "
                "repro.optim.make_optimizer(cfg, total_steps=3) (AdamW) on "
                "repro_torch.models.lm.numpy_params(cfg, seed=0), batches "
                "of repro.data.SyntheticLMData(vocab, seq, batch, seed=0"
                + (f", src_len={src}, d_model)" if src else ")")
                + ", tokens[:, :-1] against tokens[:, 1:]",
        "platform": "cpu",
        "jax": jax.__version__,
        "regenerate": "PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q "
                      "-m slow tests/test_torch_train_ssm.py -k "
                      "regenerate_train_golden",
        "config_cuts": {**cuts, "dtype": "float32"},
        **run,
        "src_len": src,
        "losses": losses,
        "grad_norms": gnorms,
        "leaf_norms": {n: float(np.linalg.norm(np.asarray(a, np.float64)))
                       for n, a in leaves.items()},
    }
    path.write_text(json.dumps(gold, indent=1) + "\n")


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(GOLDENS))
def test_port_holds_the_train_golden_on_the_cpu(arch):
    path, _ = GOLDENS[arch]
    gold = json.loads(path.read_text())
    (cfg, _), _ = _golden_configs(arch)
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
