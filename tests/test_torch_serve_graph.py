"""The serving steps as CUDA graphs (`repro_torch.serve.graph`, the port's
counterpart of the reference's `jax.jit` of its engine's decode and of its
prefill a prompt length, and of its launcher's two steps).

On the CPU the graphed steps run eagerly over the same static buffers as
on the card, with the same cache copy-back and prefill LRU: these tests
hold the graphed engine to the JAX engine's greedy tokens in the
scheduling scenarios of tests/test_torch_serve.py, to the eager engine
(`graphed=False`), and the launcher to the JAX launcher.  The capture
itself runs on the card: the `cuda` test here and chip_smoke.py's phase 4.
"""
import contextlib
import functools
import types

import numpy as np
import pytest
import torch

from conftest import FakeClock, run_schedule

try:
    import jax
    from test_torch_serve import _models
    from repro.configs import smoke_config as jax_smoke_config
    from repro.launch.serve import main as jax_serve_main
    from repro.models import get_model as jax_get_model
    from repro.serve.engine import ServeEngine as JaxServeEngine
except ImportError:     # the card's machine: only the `cuda` test runs there
    jax = None
from repro_torch.configs import smoke_config
from repro_torch.core.capture import StepGraph, leaves
from repro_torch.convert import (lm_params_from_numpy,
                                 whisper_params_from_numpy)
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import LM, Whisper, get_model
from repro_torch.serve import ServeEngine, make_decode_step
from repro_torch.serve import graph as G
from repro_torch.train import CaptureError

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

# one config of each kind of decode state: dense attention, ssm (conv and
# h returned fresh, copied back), moe (a capacity group a slot) and rec
# with ring-buffer lattn layers (the rec state copied back)
SCENARIO_ARCHS = ["llama3-8b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
                  "recurrentgemma-2b"]


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _recycling(eng, prompts):
    """3 requests through 1 slot, 3 tokens each (slot recycling)."""
    reqs = [eng.submit(p, max_new=3) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _midrun(eng, prompts):
    """4 requests arriving on a fake clock while earlier ones decode."""
    reqs = []
    events = [(0.001 * i, lambda p=p: reqs.append(eng.submit(p, 5)))
              for i, p in enumerate(prompts)]
    run_schedule(FakeClock(), events, eng.step)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


# scenario -> (the function that serves it, prompt lengths, slots, max_seq,
# prompt seed)
SCENARIOS = {"recycling": (_recycling, (4, 4, 4), 1, 32, 1),
             "midrun": (_midrun, (6, 4, 8, 5), 2, 48, 3)}


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, scenario):
    drive, lens, slots, max_seq, seed = SCENARIOS[scenario]
    jcfg, params, cfg, _ = _models(arch)
    eng = JaxServeEngine(jcfg, params, slots=slots, max_seq=max_seq)
    return drive(eng, _prompts(cfg, lens, seed))


def _port_tokens(arch, scenario, graphed):
    drive, lens, slots, max_seq, seed = SCENARIOS[scenario]
    cfg = smoke_config(arch)
    eng = ServeEngine(cfg, _model(arch), slots=slots, max_seq=max_seq,
                      graphed=graphed)
    return drive(eng, _prompts(cfg, lens, seed)), eng


@functools.lru_cache(maxsize=None)
def _model(arch):
    """The JAX package's weights where it is present, the port's own
    draw otherwise (the engines read the weights, never write them)."""
    if jax is not None:
        return _models(arch)[3]
    return get_model(smoke_config(arch), device="cpu").init(0)


@needs_jax
@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("arch", SCENARIO_ARCHS)
def test_graphed_engine_matches_jax_engine(arch, scenario):
    got, eng = _port_tokens(arch, scenario, graphed=True)
    assert eng.graphed and isinstance(eng._decode, G.GraphedDecode)
    assert got == _jax_tokens(arch, scenario)


@pytest.mark.parametrize("arch", SCENARIO_ARCHS)
def test_graphed_engine_matches_eager_engine(arch):
    graphed, _ = _port_tokens(arch, "midrun", graphed=True)
    eager, eng = _port_tokens(arch, "midrun", graphed=False)
    assert not isinstance(eng._decode, G.GraphedDecode)
    assert graphed == eager


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_cache_is_written_back_in_place(arch):
    """The ssm and rec decodes return fresh conv and h tensors: the graphed
    engine copies them into its own cache, whose tensors stay the ones it
    made (a graph's state), with the eager engine's values after the same
    requests."""
    cfg = smoke_config(arch)
    engines = [ServeEngine(cfg, _model(arch), slots=2, max_seq=32,
                           graphed=g) for g in (True, False)]
    made = [leaves(e.cache) for e in engines]
    for eng in engines:
        for p in _prompts(cfg, (6, 9, 5), 4):
            eng.submit(p, 4)
        for _ in range(3):
            eng.step()
    graphed, eager = (leaves(e.cache) for e in engines)
    assert all(a is b for a, b in zip(graphed, made[0], strict=True))
    assert any(a is not b for a, b in zip(eager, made[1]))   # rebound
    for a, b in zip(graphed, eager, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_a_replay_reads_the_updated_state(arch):
    """Three decode calls over one cache: each reads the state the last
    left, so the logits are those of three chained eager steps."""
    cfg = smoke_config(arch)
    model = _model(arch)
    tokens = _prompts(cfg, (7,), 5)[0][None]
    step = make_decode_step(cfg)
    dec = G.graphed_decode(step)
    _, cache = model.prefill(torch.from_numpy(tokens), 16)
    _, ref = model.prefill(torch.from_numpy(tokens), 16)
    made = leaves(cache)
    for i, tok in enumerate((3, 17, 5)):
        got, out = dec(model, cache, np.array([[tok]]), 7 + i)
        want, ref = step(model, ref, torch.tensor([[tok]]), 7 + i)
        assert out is cache
        assert torch.equal(got, want), f"step {i}"
    assert all(a is b for a, b in zip(leaves(cache), made, strict=True))
    assert dec.entries_built == 1


def test_one_decode_entry_an_engine_and_a_prefill_entry_a_repeated_length():
    """A prompt length's first prefill runs the plain step; its second
    builds the length's entry."""
    arch = "llama3-8b"
    cfg = smoke_config(arch)
    eng = ServeEngine(cfg, _model(arch), slots=2, max_seq=32)
    for p in _prompts(cfg, (5, 7, 5, 9, 7), 6):
        eng.submit(p, 3)
    eng.run()
    assert eng._decode.entries_built == 1
    assert eng._prefill.entries_built == 2
    assert eng._prefill.plain_calls == 3
    assert sorted(k[0][1] for k in eng._prefill.entries) == [(1, 5), (1, 7)]
    assert [k[0][1] for k in eng._prefill.seen] == [(1, 9)]
    e = eng._decode.entry
    assert e.token.shape == (2, 1) and e.pos.shape == (2,)
    assert e.token.dtype == e.pos.dtype == torch.int64
    assert e.cache is eng.cache


def test_prefill_lru_drops_the_oldest_length(monkeypatch):
    monkeypatch.setattr(G, "PREFILL_ENTRIES", 2)
    arch = "llama3-8b"
    cfg = smoke_config(arch)
    model = _model(arch)
    eng = ServeEngine(cfg, model, slots=1, max_seq=32)
    pre = eng._prefill

    def serve(*lens):
        for n in lens:
            eng.submit(_prompts(cfg, (n,), n)[0], 2)
            eng.run()
    kept = {}
    for n in (4, 5, 6, 5):
        serve(n, n)
        kept[n] = next(reversed(pre.entries.values()))
    assert [k[0][1][1] for k in pre.entries] == [6, 5]
    assert pre.entries_built == 3 and pre.plain_calls == 3
    # the oldest entry was freed as it was dropped
    assert kept[4].out is None and kept[4].inputs == {}
    # a dropped length is seen anew: its first call runs the plain step
    serve(4)
    assert [k[0][1][1] for k in pre.entries] == [6, 5]
    serve(4)
    assert [k[0][1][1] for k in pre.entries] == [5, 4]
    assert pre.entries_built == 4 and pre.plain_calls == 4
    # the lengths seen once are remembered as an LRU of the same size
    serve(7, 8, 9)
    assert [k[0][1][1] for k in pre.seen] == [8, 9]
    serve(7)
    assert [k[0][1][1] for k in pre.entries] == [5, 4]
    assert pre.plain_calls == 8


def test_prefill_outputs_are_the_entrys_static_tensors():
    """A signature's first call runs the plain step; from its second on a
    call's outputs are the entry's, overwritten by its next call (the
    graph's pool on the card)."""
    arch = "falcon-mamba-7b"
    cfg = smoke_config(arch)
    model = _model(arch)
    pre = G.graphed_prefill(
        lambda m, b: m.prefill(b["tokens"], 16))
    a, b, c = _prompts(cfg, (6, 6, 6), 7)
    l0, c0 = pre(model, {"tokens": c[None]})
    assert pre.entries_built == 0 and pre.plain_calls == 1
    la, ca = pre(model, {"tokens": a[None]})
    assert la is not l0 and pre.entries_built == 1
    la0 = la.clone()
    lb, cb = pre(model, {"tokens": b[None]})
    assert lb is la and cb is ca and pre.entries_built == 1
    want, _ = model.prefill(torch.from_numpy(b[None]), 16)
    assert torch.equal(lb, want) and not torch.equal(la0, want)
    want, _ = model.prefill(torch.from_numpy(c[None]), 16)
    assert torch.equal(l0, want)


@needs_jax
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "whisper-tiny"])
def test_launcher_graphed_steps_match_jax(arch, monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --smoke --device cpu` through
    its graphed steps (its one prefill a first sight, run by the plain
    step; one decode entry) generates the JAX launcher's token ids when
    both hold the same weights."""
    args = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12",
            "--gen", "5", "--seed", "0"]
    want = jax_serve_main(args)
    tree = jax.tree.map(np.asarray,
                        jax_get_model(jax_smoke_config(arch)).init(0))
    cls, load = (Whisper, whisper_params_from_numpy) \
        if arch == "whisper-tiny" else (LM, lm_params_from_numpy)

    def init_from_jax(self, seed=0):
        self.load_state_dict(load(self.cfg, tree, device="cpu").state_dict())
        return self
    monkeypatch.setattr(cls, "init", init_from_jax)
    made = []

    def spy(wrap):
        def make(step_fn):
            made.append(wrap(step_fn))
            return made[-1]
        return make
    import repro_torch.serve as S
    monkeypatch.setattr(S, "graphed_prefill", spy(G.graphed_prefill))
    monkeypatch.setattr(S, "graphed_decode", spy(G.graphed_decode))
    got = launch_serve.main(args + ["--device", "cpu"])
    assert "device=cpu" in capsys.readouterr().out
    np.testing.assert_array_equal(got, np.asarray(want))
    assert [type(s) for s in made] == [G.GraphedPrefill, G.GraphedDecode]
    assert [s.entries_built for s in made] == [0, 1]
    assert made[0].plain_calls == 1


def test_failed_capture_raises_capture_error_naming_the_line(monkeypatch):
    """The card's path with the capture failing inside the package: a
    `CaptureError` naming the line, the entry left without a graph, no
    fallback to the eager step."""
    from repro_torch.models.common import apply_mrope

    class Fake:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass
    fake = types.SimpleNamespace(
        current_stream=lambda *a: Fake(), Stream=Fake,
        stream=lambda s: contextlib.nullcontext(),
        synchronize=lambda *a: None, empty_cache=lambda: None,
        graph_pool_handle=lambda: None, CUDAGraph=Fake,
        graph=lambda g, pool=None: contextlib.nullcontext())
    for name, v in vars(fake).items():
        monkeypatch.setattr(torch.cuda, name, v)
    calls = []

    def work():
        calls.append(len(calls))
        if len(calls) == 2:            # the capture
            apply_mrope(torch.zeros(1, 2, 1, 8), torch.zeros(1, 2, 3), 1e4,
                        (1, 1, 1))
        return ()
    e = StepGraph(torch.device("cpu"), "graphed_decode")
    with pytest.raises(CaptureError, match=r"graphed_decode: the capture "
                       r"failed at repro_torch/models/common.py:\d+ "
                       r"\(apply_mrope\)"):
        e.build(work)
    assert calls == [0, 1] and e.graph is None and e.out is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SCENARIO_ARCHS)
def test_cuda_graphed_engine_bit_equal_to_eager(cuda, arch):
    """A smoke engine on the card captures its decode and the prefill of
    its repeated prompt length, replays them, credits their launches, and
    serves the eager engine's tokens and logits bit for bit."""
    cfg = smoke_config(arch)
    model = get_model(cfg, device=cuda).init(0)
    prompts = _prompts(cfg, (6, 4, 8, 5, 6), 3)
    outs, logits = [], []
    for graphed in (True, False):
        eng = ServeEngine(cfg, model, slots=2, max_seq=48, graphed=graphed)
        reqs = [eng.submit(p, 6) for p in prompts]
        ops.reset_launch_counts()
        eng.run()
        outs.append([r.out for r in reqs])
        toks = np.array([[r.out[-1]] for r in reqs[:2]])
        logits.append(eng._decode(model, eng.cache, toks, eng.pos)[0].clone())
        if graphed:
            assert eng._decode.entries_built == 1
            assert eng._decode.entry.graph is not None
            assert eng._prefill.entries_built == 1
            assert eng._prefill.plain_calls == 4
            counts = ops.launch_counts()
            ops.reset_launch_counts()
            eng._prefill(model, {"tokens": prompts[0][None]})   # a replay
            entry, = [e for k, e in eng._prefill.entries.items()
                      if k[0][1] == (1, len(prompts[0]))]
            assert entry.graph is not None and entry.launches
            assert ops.launch_counts() == {
                **dict.fromkeys(ops.COUNTED, 0), **entry.launches}
            assert any(counts.values())
    assert outs[0] == outs[1]
    assert torch.equal(logits[0], logits[1])
