"""The PyTorch port's Whisper (whisper-tiny, the audio family) against the
JAX package's, on the CPU.

Float32 smoke config (2 encoder and 2 decoder layers, enc_seq 16), the
reference's `Whisper(cfg).init(0)` weights carried across by
`whisper_params_from_numpy`, numpy-seeded frames and tokens; the flash
kernel runs its plain version here.  Held within 1e-5: the encoder's
output, the prefill's logits and cache, and a chain of decode steps'
logits; greedy tokens identical, through the serving steps and through
`python -m repro_torch.launch.serve --smoke --device cpu`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import main as jax_serve_main
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (whisper_params_from_numpy,
                                 whisper_params_to_numpy)
from repro_torch.kernels import ops
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import Whisper, get_model
from repro_torch.serve import (ServeEngine, make_decode_step,
                               make_prefill_step)

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke_config(ARCH)
    jm = jax_get_model(jcfg)
    params = jm.init(0)
    cfg = smoke_config(ARCH)
    model = whisper_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                      device="cpu")
    return cfg, jm, params, model


def _inputs(cfg, seed, b=2, s=9):
    r = np.random.default_rng(seed)
    frames = r.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    tokens = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return r, frames, tokens


def test_get_model_gives_whisper_with_the_reference_leaves(pair):
    cfg, jm, params, model = pair
    assert isinstance(get_model(cfg, device="cpu"), Whisper)
    ref = dict(_flat(jax.tree.map(np.asarray, params)))
    back = dict(_flat(whisper_params_to_numpy(cfg, model)))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    full = Whisper(get_config(ARCH), device="meta")
    assert len(full.enc) == 4 and len(full.dec) == 4


def test_encode_matches_reference(pair):
    cfg, jm, params, model = pair
    _, frames, _ = _inputs(cfg, 1)
    want = jm.encode(params, jnp.asarray(frames))
    got = model.encode(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("plen", [1, 9, 13])
def test_prefill_and_decode_match_reference(pair, plen):
    cfg, jm, params, model = pair
    r, frames, tokens = _inputs(cfg, plen, s=plen)
    max_seq = plen + 6
    jl, jc = jm.prefill(params, jnp.asarray(frames), jnp.asarray(tokens),
                        max_seq)
    pl, pc = model.prefill(torch.from_numpy(frames),
                           torch.from_numpy(tokens), max_seq)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]), **TOL)
    for k in ("k", "v"):
        ours = np.stack([c[k].numpy() for c in pc["self"]])
        np.testing.assert_allclose(ours, np.asarray(jc["self"][k]), **TOL)
    for step in range(5):
        tok = r.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = plen + step
        jl, jc = jm.decode(params, jc, jnp.asarray(tok),
                           jnp.asarray(pos, jnp.int32))
        pl, pc = model.decode(pc, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")


def test_serving_steps_give_the_references_greedy_tokens(pair):
    """make_prefill_step / make_decode_step with the batch's frames, as
    the reference's launcher drives them: identical greedy tokens, no
    kernel launch on the CPU."""
    cfg, jm, params, model = pair
    _, frames, tokens = _inputs(cfg, 7, b=3, s=11)
    gen, max_seq = 8, 11 + 8
    jpre = jax.jit(lambda p, b: jm.prefill(p, b["frames"], b["tokens"],
                                           max_seq))
    jdec = jax.jit(lambda p, c, t, q: jm.decode(p, c, t, q))
    logits, cache = jpre(params, {"frames": jnp.asarray(frames),
                                  "tokens": jnp.asarray(tokens)})
    want = [np.asarray(jnp.argmax(logits, -1))]
    for i in range(gen - 1):
        tok = jnp.asarray(want[-1][:, None], jnp.int32)
        logits, cache = jdec(params, cache, tok,
                             jnp.asarray(11 + i, jnp.int32))
        want.append(np.asarray(jnp.argmax(logits, -1)))
    ops.reset_launch_counts()
    prefill, decode = make_prefill_step(cfg, max_seq), make_decode_step(cfg)
    logits, cache = prefill(model, {"frames": torch.from_numpy(frames),
                                    "tokens": torch.from_numpy(tokens)})
    got = [torch.argmax(logits, -1).numpy()]
    for i in range(gen - 1):
        logits, cache = decode(model, cache,
                               torch.from_numpy(got[-1][:, None]), 11 + i)
        got.append(torch.argmax(logits, -1).numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert ops.launch_counts() == dict.fromkeys(ops.COUNTED, 0)


def test_decode_takes_a_position_a_row(pair):
    """Rows at different depths (prompts of 6 and 9 tokens, their caches
    side by side) decode with a [B] position vector as each row alone."""
    cfg, _, _, model = pair
    r, frames, _ = _inputs(cfg, 3)
    alone, caches = [], []
    for i, n in enumerate((6, 9)):
        toks = torch.from_numpy(
            r.integers(0, cfg.vocab_size, (1, n)).astype(np.int32))
        _, c = model.prefill(torch.from_numpy(frames[i:i + 1]), toks, 16)
        caches.append(c)
        alone.append(model.decode({**c, "self": [dict(l) for l in
                                                 c["self"]]},
                                  torch.tensor([[5 + i]]), n)[0])
    both = {"self": [{k: torch.cat([a[k], b[k]]) for k in a}
                     for a, b in zip(caches[0]["self"], caches[1]["self"])],
            **{k: torch.cat([caches[0][k], caches[1][k]], dim=1)
               for k in ("cross_k", "cross_v")}}
    got, _ = model.decode(both, torch.tensor([[5], [6]]), np.array([6, 9]))
    torch.testing.assert_close(got, torch.cat(alone), rtol=1e-5, atol=1e-5)


def test_launch_serve_matches_jax(monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --arch whisper-tiny --smoke
    --device cpu` (stub frames from --seed) generates the JAX launcher's
    token ids when both hold the same weights."""
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "12",
            "--gen", "5", "--seed", "0"]
    want = jax_serve_main(args)
    tree = jax.tree.map(np.asarray,
                        jax_get_model(jax_smoke_config(ARCH)).init(0))

    def init_from_jax(self, seed=0):
        assert seed == 0
        loaded = whisper_params_from_numpy(self.cfg, tree, device="cpu")
        self.load_state_dict(loaded.state_dict())
        return self
    monkeypatch.setattr(Whisper, "init", init_from_jax)
    got = serve_main(args + ["--device", "cpu"])
    assert "device=cpu" in capsys.readouterr().out
    np.testing.assert_array_equal(got, np.asarray(want))


def test_engine_and_training_refuse_the_audio_family(pair):
    """The serve engine still refuses Whisper (the reference's message);
    training takes it: `loss` on a batch of frames, tokens and labels is
    finite and gives every parameter a gradient."""
    cfg, _, _, model = pair
    with pytest.raises(ValueError, match="Whisper API"):
        ServeEngine(cfg, model)
    r, frames, tokens = _inputs(cfg, 6)
    labels = r.integers(0, cfg.vocab_size, tokens.shape).astype(np.int32)
    model = whisper_params_from_numpy(cfg, whisper_params_to_numpy(
        cfg, model), device="cpu").train_mode()
    leaves = dict(model.named_leaves())
    loss, _ = model.loss({"frames": frames, "tokens": tokens,
                          "labels": labels})
    assert np.isfinite(float(loss.detach()))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert all(g is not None and g.shape == p.shape
               for g, p in zip(grads, leaves.values()))
