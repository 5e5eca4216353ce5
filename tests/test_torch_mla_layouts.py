"""deepseek-v2-lite's slot and paged MLA decodes at the lengths of
`chip_smoke.py` phase 10: a slot row of 552 positions against a page
table as wide as its pool (280 pages of 16 = 4,480 positions).  In f32
the absorbed attention's reductions took their terms in an order set by
that length, so the masked tail moved the result: on the CPU at 302
against 552 positions, and on the card, where the two routes' layer-0
attention outputs came out up to 2 bf16 ulps apart and parted their greedy
tokens at near-ties.  `nn.attention._mla_absorbed` runs in f64 on every
device: one result at every length, within 1e-6 of the reference's f32
math, and the two routes' logits bit for bit."""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
# the serving package before launch.steps: the reverse order is a cycle
from repro_torch.serving.paging import init_page_pool, page_write
from repro_torch.nn.attention import NEG_INF, _mla_absorbed
from repro_torch.nn.model import decode_step, init_params, prefill

CFG = get_config("deepseek-v2-lite-16b", smoke=True)
PARAMS = init_params(CFG, seed=0, device="cpu")
SLOT_LEN, PAGE, N_PAGES = 552, 16, 280


def _f32_absorbed(params, q_nope, q_rope, ckv, kr, valid, cfg):
    """The reference's f32 order, written out."""
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    w_uk = params["w_uk"].float().reshape(r, H, nope)
    w_uv = params["w_uv"].float().reshape(r, H, cfg.v_head_dim)
    q_eff = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk)
    s = torch.einsum("bshr,bkr->bhsk", q_eff, ckv.float())
    s = s + torch.einsum("bshd,bkd->bhsk", q_rope.float(), kr.float())
    s = s * (1.0 / math.sqrt(nope + rope_d))
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    ctx = torch.einsum("bhsk,bkr->bshr", torch.softmax(s, -1), ckv.float())
    return torch.einsum("bshr,rhv->bshv", ctx, w_uv)


def _attn_params():
    return next(seg for seg in PARAMS["stack"]["segments"]
                if "attn" in seg)["attn"]


def _inputs(length, seed):
    g = torch.Generator().manual_seed(seed)
    H, r = CFG.n_heads, CFG.kv_lora_rank
    B, pos = 2, torch.tensor([37, 301])
    q_nope = torch.randn(B, 1, H, CFG.qk_nope_dim, generator=g)
    q_rope = torch.randn(B, 1, H, CFG.qk_rope_dim, generator=g)
    ckv = torch.randn(B, length, r, generator=g).to(torch.bfloat16)
    kr = torch.randn(B, length, CFG.qk_rope_dim, generator=g).to(
        torch.bfloat16)
    valid = (torch.arange(length)[None, :] <= pos[:, None])[:, None, :]
    return q_nope, q_rope, ckv, kr, valid


@pytest.mark.parametrize("length", [SLOT_LEN, PAGE * N_PAGES])
def test_absorbed_on_the_cpu_is_the_reference_f32(length):
    """The f64 route, rounded to f32, within 1e-6 of the reference's f32
    math (its max magnitude) on the CPU."""
    args = _inputs(length, seed=length)
    got = _mla_absorbed(_attn_params(), *args, CFG)
    want = _f32_absorbed(_attn_params(), *args, CFG)
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_the_cards_route_does_not_depend_on_the_masked_tail():
    """The route the card runs, and now the CPU too: the same rows over
    302, 552 and 4,480 positions (every position past 301 masked) give
    one result, bit for bit.  The f32 math fails this on the CPU (302
    against 552 positions)."""
    q_nope, q_rope, ckv, kr, valid = _inputs(PAGE * N_PAGES, seed=3)
    outs = [_mla_absorbed(_attn_params(), q_nope, q_rope, ckv[:, :n],
                          kr[:, :n], valid[..., :n], CFG)
            for n in (302, SLOT_LEN, PAGE * N_PAGES)]
    assert all(o.dtype == torch.float32 for o in outs)
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_slot_and_paged_decode_at_phase10_lengths_are_bit_equal():
    """Two prompts (40 and 23 tokens) prefilled into a slot cache of 552
    and into scattered pages of a 280-page pool whose tables are 280
    wide; six decode steps: logits equal bit for bit."""
    rng = np.random.default_rng(10)
    lens = (40, 23)
    slot, pool = None, init_page_pool(CFG, N_PAGES + 1, PAGE, device="cpu")
    tables = np.zeros((len(lens), N_PAGES), np.int32)
    free = list(rng.permutation(np.arange(1, N_PAGES + 1)))
    toks, rows = [], []
    for b, n in enumerate(lens):
        prompt = torch.from_numpy(rng.integers(1, CFG.vocab, (1, n)))
        logits, one = prefill(PARAMS, {"tokens": prompt}, CFG, SLOT_LEN)
        rows.append(one)
        toks.append(int(logits[0, :CFG.vocab].argmax()))
        blocks = -(-(n + 8) // PAGE)
        tables[b, :blocks] = [free.pop() for _ in range(blocks)]
        _, staged = prefill(PARAMS, {"tokens": prompt}, CFG, blocks * PAGE)
        for i in range(blocks):
            page_write(CFG, pool, staged, i, int(tables[b, i]))
    slot = [{"attn": {k: torch.cat([r[s]["attn"][k] for r in rows])
                      for k in rows[0][s]["attn"]}}
            for s in range(len(rows[0]))]
    tok = torch.tensor(toks)
    pos = torch.tensor(lens, dtype=torch.int32)
    table = torch.from_numpy(tables)
    for _ in range(6):
        ls, slot = decode_step(PARAMS, tok, slot, pos, CFG)
        lp, pool = decode_step(PARAMS, tok, pool, pos, CFG, table)
        assert torch.equal(ls, lp)
        tok = ls[:, :CFG.vocab].argmax(-1)
        pos = pos + 1
