"""The PyTorch port's serving path against the JAX package's, on the CPU.

The port's `ServeEngine` (one decode over all slots with a per-slot
position vector) must give exactly the greedy tokens of the JAX
`ServeEngine` (a vmapped batch-1 decode) on the same weights — the
reference's `model.init(0)` carried across with `lm_params_from_numpy` —
in the scenarios of tests/test_serve_engine.py.  Float32 smoke configs;
the configs with QKV biases get random nonzero ones (the reference's are
zero at init)."""
import functools

import jax
import numpy as np
import pytest
import torch

from conftest import FakeClock, run_schedule
from test_torch_models import with_biases

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import main as jax_serve_main
from repro.models import get_model as jax_get_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import LM
from repro_torch.serve.engine import ServeEngine

ARCHS = ["llama3-8b", "falcon-mamba-7b", "minitron-4b", "phi3-medium-14b",
         "qwen2-72b", "qwen3-moe-30b-a3b", "arctic-480b", "qwen2-vl-72b",
         "recurrentgemma-2b"]
# the engine's scheduling scenarios, one config of each kind of decode
# state: dense and moe layers (whose engine decode routes a capacity group
# a slot), ssm layers, and rec with ring-buffer lattn layers; the other
# dense configs differ from llama3-8b only in widths and biases, which the
# tests of every arch cover
SCENARIO_ARCHS = ["llama3-8b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
                  "arctic-480b", "recurrentgemma-2b"]


@functools.lru_cache(maxsize=None)
def _models(arch, seed=0):
    """(JAX cfg, JAX params, port cfg, port model with JAX's weights); one
    pair an arch for the file (the engines read the weights, never write
    them)."""
    jcfg = jax_smoke_config(arch)
    params = jax_get_model(jcfg).init(seed)
    if jcfg.qkv_bias:
        params = with_biases(params, seed)
    cfg = smoke_config(arch)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return jcfg, params, cfg, model


def _serve_both(arch, lens, max_new, slots, max_seq, seed):
    jcfg, params, cfg, model = _models(arch)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    outs = []
    for eng in (JaxServeEngine(jcfg, params, slots=slots, max_seq=max_seq),
                ServeEngine(cfg, model, slots=slots, max_seq=max_seq)):
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        outs.append([r.out for r in reqs])
    return outs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    # 3 requests > 2 slots, as in test_serve_engine.py
    ref, ours = _serve_both(arch, (5, 9, 7), 6, slots=2, max_seq=48, seed=0)
    assert ours == ref
    assert all(len(o) == 6 for o in ours)


@pytest.mark.parametrize("arch", SCENARIO_ARCHS)
def test_engine_slot_recycling(arch):
    ref, ours = _serve_both(arch, (4, 4, 4), 3, slots=1, max_seq=32, seed=1)
    assert ours == ref
    assert all(len(o) == 3 for o in ours)


def test_engine_rids_unique_across_queue_drain():
    _, _, cfg, model = _models("llama3-8b")
    eng = ServeEngine(cfg, model, slots=1, max_seq=32)
    rng = np.random.default_rng(2)

    def sub(**kw):
        return eng.submit(rng.integers(0, cfg.vocab_size, 4).astype(np.int32),
                          2, **kw)

    a = sub()
    eng.run()                       # queue drains back to empty
    b = sub()                       # would have re-issued rid 0
    c = sub(rid=40)                 # explicit ids advance the counter too
    d = sub()
    eng.run()
    rids = [r.rid for r in (a, b, c, d)]
    assert len(set(rids)) == 4, rids
    assert d.rid > c.rid == 40 > b.rid > a.rid


@pytest.mark.parametrize("arch", SCENARIO_ARCHS)
def test_engine_scripted_midrun_arrivals(arch):
    """Requests arriving while earlier ones decode, on the shared fake-clock
    schedule, give the JAX engine's tokens under the same schedule."""
    jcfg, params, cfg, model = _models(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 4, 8, 5)]       # 4 requests > 2 slots
    outs = []
    for eng in (JaxServeEngine(jcfg, params, slots=2, max_seq=48),
                ServeEngine(cfg, model, slots=2, max_seq=48)):
        reqs = []
        events = [(0.001 * i, lambda p=p, e=eng: reqs.append(e.submit(p, 5)))
                  for i, p in enumerate(prompts)]
        run_schedule(FakeClock(), events, eng.step)
        eng.run()                           # drain the stragglers
        assert all(r.done for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[1] == outs[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_matches_jax(arch, monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --smoke --device cpu` generates
    the JAX launcher's token ids when both hold the same weights (the
    port's init draws other numbers, so the test hands it JAX's)."""
    args = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12",
            "--gen", "5", "--seed", "0"]
    want = jax_serve_main(args)
    tree = jax.tree.map(np.asarray,
                        jax_get_model(jax_smoke_config(arch)).init(0))

    def init_from_jax(self, seed=0):
        assert seed == 0
        loaded = lm_params_from_numpy(self.cfg, tree, device="cpu")
        self.load_state_dict(loaded.state_dict())
        return self
    monkeypatch.setattr(LM, "init", init_from_jax)
    got = serve_main(args + ["--device", "cpu"])
    assert "device=cpu" in capsys.readouterr().out
    np.testing.assert_array_equal(got, np.asarray(want))


def test_cpu_serving_counts_no_kernel_launches():
    _, _, cfg, model = _models("falcon-mamba-7b")
    ops.reset_launch_counts()
    eng = ServeEngine(cfg, model, slots=2, max_seq=32)
    eng.submit(np.arange(9, dtype=np.int32), 3)
    eng.run()
    assert ops.launch_counts() == dict.fromkeys(ops.COUNTED, 0)


def test_engine_refuses_the_audio_family():
    # with the reference's message: Whisper serves through the steps
    cfg = smoke_config("llama3-8b").replace(family="audio")
    with pytest.raises(ValueError, match="enc-dec engine: use Whisper API"):
        ServeEngine(cfg, LM(smoke_config("llama3-8b"), device="meta"))


def test_serve_launcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--arch", "llama3-8b", "--smoke"])
