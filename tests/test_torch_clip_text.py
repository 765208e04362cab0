"""The CLIP text tower against the JAX package on the CPU: the tokenizer's
ids (with `regex` and with the standard `re` fallback, which the card's
machine takes), its vocabulary file byte for byte, the causal text encoder
with and without the token-embedding LoRA, the LoRA embedding helpers,
PromptLearner and its prompts through the encoder, and convert_clip_text.
Every flax leaf is a seeded random value (token LoRA's A too: its zero init
would hide the delta); f32 at TOL."""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.models import clip_text as jtext
from demo2_tpu.utils import bpe as jbpe
from demo2_tpu.utils.converters import convert_clip_text as j_convert_clip_text
from demo2_tpu_torch.models import clip_text as ttext
from demo2_tpu_torch.utils import bpe as tbpe
from demo2_tpu_torch.utils.converters import convert_clip_text, convert_flax_variables
from torch_port_helpers import CPU, apply_jit, generator, load_port, n, random_variables, t

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPTS = ["A photo of a X X X X person.", "A photo of a X X X X vehicle.",
           "a man in a red jacket, walking", "Two people at the gate's camera 3!",
           "  HTML &amp; entities  and   spaces ", "naïve café", ""]
TINY = dict(width=32, layers=2, heads=4, embed_dim=16)


def test_vocabulary_is_the_jax_packages_byte_for_byte():
    assert tbpe.VOCAB_PATH != jbpe.VOCAB_PATH
    assert filecmp.cmp(tbpe.VOCAB_PATH, jbpe.VOCAB_PATH, shallow=False)


@pytest.mark.parametrize("pattern", ["regex", "re"])
def test_token_ids_match_jax(pattern, monkeypatch):
    """tokenize's (N, 77) ids equal JAX's; without `regex` (the standard
    `re` fallback, ASCII classes) on the ASCII prompts."""
    prompts = PROMPTS
    if pattern == "re":
        monkeypatch.setattr(tbpe, "_re", None)
        monkeypatch.setattr(tbpe, "_default_tokenizer", tbpe._default_tokenizer.__wrapped__)
        prompts = [p for p in PROMPTS if p.isascii()]
    got = tbpe.tokenize(prompts)
    np.testing.assert_array_equal(got, jbpe.tokenize(prompts))
    assert got.dtype == np.int32 and got.shape == (len(prompts), 77)
    assert tbpe.ClipBPE().decode(tbpe.ClipBPE().encode("a photo")).strip() == "a photo"
    with pytest.raises(RuntimeError, match="too long"):
        tbpe.tokenize("word " * 80)
    np.testing.assert_array_equal(tbpe.tokenize("word " * 80, truncate=True),
                                  jbpe.tokenize("word " * 80, truncate=True))


def _text_pair(lora_rank):
    ids = jbpe.tokenize(PROMPTS[:4])
    jm = jtext.CLIPTextTransformer(**TINY, lora_rank=lora_rank, lora_alpha=0.5)
    var = random_variables(jm, ids, seed=3)
    port = load_port(ttext.CLIPTextTransformer(**TINY, lora_rank=lora_rank, lora_alpha=0.5,
                                               dtype=F32, device=CPU, generator=generator()),
                     var)
    return ids, jm, var, port


@pytest.mark.parametrize("lora_rank", [0, 3], ids=["plain", "token_lora"])
def test_text_encoder_matches_jax(lora_rank):
    ids, jm, var, port = _text_pair(lora_rank)
    want = apply_jit(jm, var, ids)
    with torch.no_grad():
        got = port(t(ids))
    assert got.dtype == F32 and got.shape == (4, TINY["embed_dim"])
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_lora_embedding_helpers_match_jax():
    rng = np.random.default_rng(4)
    tok, a, b = (rng.standard_normal(s).astype(np.float32) for s in ((50, 8), (3, 50), (8, 3)))
    ids = rng.integers(0, 50, (2, 7))
    np.testing.assert_allclose(
        n(ttext.lora_embedding_delta(t(a), t(b), t(ids), 0.5)),
        np.asarray(jtext.lora_embedding_delta(jnp.asarray(a), jnp.asarray(b), ids, 0.5)), **TOL)
    table = ttext.adapted_token_embedding(t(tok), t(a), t(b), 0.5)
    np.testing.assert_allclose(n(table), np.asarray(jtext.adapted_token_embedding(
        jnp.asarray(tok), jnp.asarray(a), jnp.asarray(b), 0.5)), **TOL)
    # row for row the lookup plus its delta
    np.testing.assert_allclose(n(table[t(ids)]), n(t(tok)[t(ids)] + ttext.lora_embedding_delta(
        t(a), t(b), t(ids), 0.5)), **TOL)


@pytest.mark.parametrize("vehicle", [False, True], ids=["person", "vehicle"])
def test_prompt_learner_matches_jax(vehicle):
    """The learned prompts, then through the encoder's embedded path at the
    template's EOT, with the token LoRA merged into the table."""
    ids, jm, var, port = _text_pair(3)
    labels = np.array([4, 0, 2], np.int32)
    jpl = jtext.PromptLearner(num_class=5, ctx_dim=TINY["width"], vehicle=vehicle)
    p = var["params"]
    jtable = jtext.adapted_token_embedding(p["token_embedding"], p["token_lora_a"],
                                           p["token_lora_b"], 0.5)
    pvar = random_variables(jpl, labels, jtable, seed=5)
    tpl = load_port(ttext.PromptLearner(5, ctx_dim=TINY["width"], vehicle=vehicle, device=CPU,
                                        generator=generator()), pvar)
    assert tpl.eot_pos == jpl.eot_pos
    np.testing.assert_array_equal(tpl.template_ids, jpl.template_ids)
    table = ttext.adapted_token_embedding(port.token_embedding, port.token_lora_a,
                                          port.token_lora_b, 0.5)
    with torch.no_grad():
        prompts = tpl(t(labels).long(), table)
        got = port(prompt_embeds=prompts, eot_idx=tpl.eot_pos)
    jprompts = apply_jit(jpl, pvar, labels, jtable)
    np.testing.assert_allclose(n(prompts), np.asarray(jprompts), **TOL)
    want = apply_jit(jm, var, prompt_embeds=jprompts, eot_idx=jpl.eot_pos)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        port(t(ids), prompt_embeds=prompts, eot_idx=0)


def test_convert_clip_text_matches_jax():
    """A CLIP text tower's state dict (random, the reference's names) through
    the port's convert_clip_text equals JAX's tree converted to the port."""
    model = ttext.CLIPTextTransformer(**TINY, dtype=F32, device=CPU, generator=generator())
    rng = np.random.default_rng(6)
    sd = {"token_embedding.weight": model.token_embedding.shape,
          "positional_embedding": model.positional_embedding.shape,
          "ln_final.weight": (32,), "ln_final.bias": (32,),
          "text_projection": model.text_projection.shape}
    for i in range(TINY["layers"]):
        blk = f"transformer.resblocks.{i}."
        sd.update({blk + "attn.in_proj_weight": (96, 32), blk + "attn.in_proj_bias": (96,),
                   blk + "attn.out_proj.weight": (32, 32), blk + "attn.out_proj.bias": (32,),
                   blk + "ln_1.weight": (32,), blk + "ln_1.bias": (32,),
                   blk + "ln_2.weight": (32,), blk + "ln_2.bias": (32,),
                   blk + "mlp.c_fc.weight": (128, 32), blk + "mlp.c_fc.bias": (128,),
                   blk + "mlp.c_proj.weight": (32, 128), blk + "mlp.c_proj.bias": (32,)})
    sd = {k: rng.standard_normal(tuple(s)).astype(np.float32) for k, s in sd.items()}
    got = convert_clip_text(sd)
    model.load_state_dict(got, strict=True)
    want = convert_flax_variables({"params": j_convert_clip_text(sd)}, model)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
