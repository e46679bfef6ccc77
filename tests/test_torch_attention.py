"""Port parity for K6's contract: flash attention with GQA.

The port's ``flash_attention`` on CPU tensors (K6's plain version) against
the reference's ``repro.kernels.attention.flash_attention``, which runs its
Pallas kernel in interpret mode on the CPU, and against ``attention_ref``,
at the reference's own test shapes (tests/test_kernels.py) and inputs.
Both sides sum float32 in their own order, the reference's kernel through
an online softmax: rtol 1e-5 / atol 1e-6 on outputs of order 1; bf16 at
the reference's own bf16 bound, 3e-2.  Decode's ``kv_len`` and the model's
strided ``[B, S, H, Dh]`` views are held to the reference model's einsum
attention (``transformer._attention_block``).  The CUDA kernel is held
against the plain version in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention_ref, flash_attention as ref_fa
from repro.models import transformer as ref_lm
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.attention import (
    attention_plain, flash_attention, flash_attention_kernel)

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=3e-2, atol=3e-2)
SHAPES = [(2, 4, 2, 256, 64, True), (1, 8, 1, 128, 32, True),
          (2, 4, 4, 384, 64, False), (1, 2, 1, 100, 64, True),
          (1, 16, 2, 128, 128, True), (1, 16, 2, 200, 128, True)]


def _qkv(b, hq, hkv, sq, sk, dh, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hq, sq, dh)) * 0.2).astype(np.float32)
    k = (rng.standard_normal((b, hkv, sk, dh)) * 0.2).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, dh)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    before = dict(LAUNCHES)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert LAUNCHES == before, "a CPU tensor launched a kernel"
    return out


@pytest.mark.parametrize("b,hq,hkv,s,dh,causal", SHAPES)
def test_flash_attention_matches_reference(b, hq, hkv, s, dh, causal):
    q, k, v = _qkv(b, hq, hkv, s, s, dh, s + dh)
    got = _port(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_fa(jq, jk, jv, causal=causal)), **F32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(attention_ref(jq, jk, jv, causal=causal)),
        **F32)


def test_flash_attention_bf16_matches_reference():
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, 5)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = flash_attention(*(torch.from_numpy(a).bfloat16() for a in
                            (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    for want in (ref_fa(jq, jk, jv, causal=True),
                 attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("hq,hkv,pos,sq,dh,smax", [
    (4, 2, 0, 1, 16, 100), (4, 2, 37, 1, 16, 100), (2, 1, 63, 1, 16, 100),
    (4, 4, 99, 1, 16, 100),
    # Sq > 64 over a cache, as a layer with a cache calls K6 (the shapes of
    # the wgmma prefill kernel: Dh 64, and Dh 128 with group 8)
    (4, 2, 199, 100, 64, 300), (16, 2, 150, 129, 128, 256)])
def test_kv_len_over_a_strided_cache_matches_reference_decode(hq, hkv, pos,
                                                              sq, dh, smax):
    """Decode: ``sq`` queries over a ``[B, Smax, Hkv, Dh]`` cache, keys
    past ``pos`` masked (the reference's ``kv_pos_limit``, the port's
    ``kv_len = pos + 1``), through the model's transposed views; one query,
    or more than 64 (a prompt chunk over a cache)."""
    b = 2
    rng = np.random.default_rng(pos)
    q = (rng.standard_normal((b, sq, hq, dh)) * 0.5).astype(np.float32)
    ck = (rng.standard_normal((b, smax, hkv, dh)) * 0.5).astype(np.float32)
    cv = rng.standard_normal((b, smax, hkv, dh)).astype(np.float32)
    want = np.asarray(ref_lm._attention_block(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), False,
        kv_pos_limit=jnp.int32(pos)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, ck, cv))
    got = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                          tv.transpose(1, 2), causal=False,
                          kv_len=pos + 1).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("hq,hkv,s", [(4, 2, 50), (2, 2, 64), (8, 1, 70)])
def test_causal_over_strided_views_matches_reference_prefill(hq, hkv, s):
    b, dh = 2, 32
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for h in (hq, hkv, hkv))
    want = np.asarray(ref_lm._attention_block(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    assert not tq.is_contiguous()
    got = flash_attention(tq, tk, tv, causal=True)
    # laid out as the model's [B, S, H, Dh]: transposing back is free
    assert got.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, **F32)


def test_q_start_slices_the_causal_queries():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 96, 96, 32, 3))
    full = attention_plain(q, k, v, causal=True)
    part = attention_plain(q[:, :, 40:], k, v, causal=True, q_start=40)
    np.testing.assert_allclose(part.numpy(), full[:, :, 40:].numpy(),
                               **F32)


def test_wrapper_refuses_what_k6_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 8, 8, 64, 0))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q, k.bfloat16(), v)
    q8, k8, v8 = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 8, 8, 8, 0))
    with pytest.raises(ValueError, match="head dim 8"):
        flash_attention(q8, k8, v8)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, v, kv_len=0)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="no kernel for devices"):
        flash_attention_kernel(q.to("meta"), k.to("meta"), v.to("meta"),
                               causal=True)


def test_wrapper_refuses_what_the_wgmma_route_does_not_take():
    """The wgmma prefill kernel reads q, k and v through TMA maps, whose
    strides stay below 2**40 bytes, at 32-bit coordinates: the wrapper
    refuses larger strides or extents before it looks at the device (meta
    tensors: nothing is allocated)."""
    ok = torch.empty((1, 2, 128, 64), dtype=torch.bfloat16, device="meta")
    far = torch.empty_strided((1, 2, 128, 64), (2**41, 2**40, 64, 1),
                              dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=r"2\*\*40 bytes"):
        flash_attention_kernel(far, ok, ok, causal=True)
    with pytest.raises(ValueError, match=r"2\*\*40 bytes"):
        flash_attention_kernel(ok, ok, far, causal=True)
    long = torch.empty((1, 2, 2**31, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=r"below 2\*\*31"):
        flash_attention_kernel(ok, long, long, causal=False)


# the decode kernel's geometry (largest Sq, query rows a CTA, keys a tile)
# in bf16 at Dh 64, as csrc/attention.cu reports it; float32 at Dh 128 has
# 64-key tiles
BF16_DH64 = (64, 4, 128)


@pytest.mark.parametrize("b,hq,hkv,sq,kv_len,geometry,want", [
    # prefill: never split
    (8, 16, 16, 2048, 2048, BF16_DH64, 1),
    # request A's decode: 128 CTAs, 17 tiles
    (8, 16, 16, 1, 2080, BF16_DH64, 1),
    # request B's decode: 16 CTAs, 257 tiles
    (1, 16, 16, 1, 32784, BF16_DH64, 8),
    # 1 tile: too few to split
    (1, 8, 8, 1, 128, BF16_DH64, 1),
    # 32 tiles: 8 splits of 4
    (1, 8, 8, 1, 4096, BF16_DH64, 8),
    # 4,096 CTAs already fill 132 SMs
    (64, 64, 64, 1, 32768, BF16_DH64, 1),
    # GQA: 40 rows per kv head, 10 chunks of 4
    (2, 16, 2, 5, 4096, BF16_DH64, 3),
    # 64 tiles of 64 keys: 16 splits of 4
    (1, 8, 8, 1, 4096, (64, 4, 64), 16),
])
def test_split_count_fills_the_card_in_decode_only(b, hq, hkv, sq, kv_len,
                                                   geometry, want):
    from repro_torch.kernels.attention.kernel import split_count

    assert split_count(b, hq, hkv, sq, kv_len, 132, geometry) == want


def _k6_int8_probe():
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1]
            / "tools/k6_int8_probe.py")
    spec = importlib.util.spec_from_file_location("k6_int8_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", list(_k6_int8_probe().VARIANTS))
def test_k6_int8_probe_edits_find_their_text(variant):
    """Every source edit of tools/k6_int8_probe.py finds its text, once, in
    csrc/attention.cu (K6's int8 dequantisation), so the probe cannot
    rot."""
    probe = _k6_int8_probe()
    edits = probe.VARIANTS[variant]
    src = probe.edited_source(variant, [])
    got = probe.edited_source(variant, edits)
    assert edits
    for old, new in edits:
        assert src.count(old) == 1
        assert new in got
    assert got != src
