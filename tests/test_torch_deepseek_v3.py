"""The port's DeepSeek-V3 LM (models/deepseek_v3.py, ops/experts.py) against
the plain float32 reference (benchmark/reference/deepseek_v3.py) at a small
size on the CPU, with seeded random weights: 3 layers (1 dense, 2 MoE), 8
experts top-2 plus 1 shared, 4 heads, a latent of 32 + rope 16, a
vocabulary of 512.

Logits are compared, never sampled tokens. Everything runs in float32
here, so port and reference differ only in the order of their sums
(absorbed against expanded attention, grouped against per-expert
products): ~1e-6 of logits that spread by ~1. The tolerance TOL = 1e-4
is ~70 times that, and far below what bf16 costs (its 8-bit mantissa moves
these logits by 7e-3 in the attention and 1e-2 in the experts:
`test_bf16_experts_or_attention_fail_the_tolerance`).
Each of three planted faults must break the comparison it targets.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import deepseek_v3 as R
from clipcap_tpu_torch.core.config import DeepseekV3Config
from clipcap_tpu_torch.decode.engine import GenerationSettings
from clipcap_tpu_torch.decode.serving import Request, ServingEngine, _GraphStep
from clipcap_tpu_torch.models import deepseek_v3 as M
from clipcap_tpu_torch.ops import experts as X

CFG = DeepseekV3Config(vocab_size=512, hidden_size=64, intermediate_size=128,
                       moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
                       n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
                       first_k_dense_replace=1, kv_lora_rank=32, qk_nope_head_dim=16,
                       qk_rope_head_dim=16, v_head_dim=16, rope_theta=50000.0,
                       max_position_embeddings=256)
TOL = 1e-4
P = 5  # prefix positions


def _model(seed=0):
    """The port's LM in f32: the blocks' matrices at std 0.1 (at std 0.02
    and these widths a block barely moves the residual stream, and no
    rounding inside it would show), a router bias large enough to change
    the choice of experts, and a final norm that spreads the logits by ~1."""
    torch.manual_seed(seed)
    lm = M.DeepseekV3(CFG, device="cpu", dtype=torch.float32, seed=seed)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if p.dim() >= 2 and name not in ("embed", "head.weight"):
                p.mul_(5.0)
        gen = torch.Generator().manual_seed(seed + 7)
        for block in lm.layers[CFG.first_k_dense_replace:]:
            block.mlp.router_bias.copy_(torch.randn(CFG.n_routed_experts, generator=gen) * 0.3)
        lm.norm.weight.fill_(6.0)
    return lm.eval()


def _reference(lm):
    w = {"lm." + k: v.detach() for k, v in lm.state_dict().items()}
    return R.LM(w, dataclasses.asdict(CFG))


def _forward_error(lm, ref, seed=1):
    x = torch.randn(3, 9, CFG.hidden_size, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        return float((lm(x) - ref.logits(x)).abs().max())


def test_forward_matches_the_reference():
    lm = _model()
    assert _forward_error(lm, _reference(lm)) < TOL


def test_router_weights_are_the_unbiased_scores_normalized():
    lm = _model()
    moe = lm.layers[1].mlp
    x = torch.randn(16, CFG.hidden_size, generator=torch.Generator().manual_seed(3))
    experts, weights = X.route(x, moe.router.weight, moe.router_bias, 2, 2.446)
    scores = torch.sigmoid(x @ moe.router.weight.T)
    want = torch.topk(scores + moe.router_bias, 2).indices
    assert torch.equal(experts.sort(-1).values, want.sort(-1).values)
    picked = scores.gather(-1, experts)
    torch.testing.assert_close(weights, picked / picked.sum(-1, keepdim=True) * 2.446)


def test_grouped_products_drop_no_token():
    """Every (token, expert) pair reaches its expert whatever the load: one
    expert takes every token here."""
    lm = _model()
    moe = lm.layers[1].mlp
    x = torch.randn(12, CFG.hidden_size, generator=torch.Generator().manual_seed(4))
    experts = torch.stack([torch.full((12,), 5), torch.arange(12) % 8], -1)
    weights = torch.rand(12, 2, generator=torch.Generator().manual_seed(5))
    got = X.routed_experts(x, experts, weights, moe.experts.gate_up, moe.experts.down)
    want = torch.zeros(12, CFG.hidden_size)
    for t in range(12):
        for j in range(2):
            e = int(experts[t, j])
            want[t] += weights[t, j] * R.swiglu(x[t], moe.experts.gate_up[e],
                                                moe.experts.down[e])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_experts_or_attention_fail_the_tolerance():
    """The tolerance is tight enough to see bf16 where the test states f32:
    the experts' products, or the attention's, rounded to bf16."""
    lm = _model()
    ref = _reference(lm)
    orig = X.grouped_mm_plain

    def bf16_experts(x, w, offs):
        return orig(x.bfloat16(), w.bfloat16(), offs).float()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(X, "grouped_mm_plain", bf16_experts)
        assert _forward_error(lm, ref) > 10 * TOL
    orig_attn = M.dot_product_attention

    def bf16_attention(q, k, v, bias=None, scale=None):
        return orig_attn(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, scale).float()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "dot_product_attention", bf16_attention)
        assert _forward_error(lm, ref) > 10 * TOL


def test_fault_bias_in_the_combine_weights_fails():
    lm = _model()
    ref = _reference(lm)

    def biased(x, gate_w, bias, k, scale, norm_topk=True):
        s = torch.sigmoid(torch.nn.functional.linear(x.float(), gate_w.float())) + bias
        experts = torch.topk(s, k, dim=-1).indices
        w = s.gather(-1, experts)
        return experts, w / w.sum(-1, keepdim=True) * scale

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(X, "route", biased)
        assert _forward_error(lm, ref) > 10 * TOL


def test_fault_one_dropped_token_fails():
    lm = _model()
    ref = _reference(lm)
    orig = X.routed_experts

    def dropping(x, experts, weights, *a, **k):
        weights = weights.clone()
        weights[0, 0] = 0.0  # the first token's first expert never sees it
        return orig(x, experts, weights, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(X, "routed_experts", dropping)
        assert _forward_error(lm, ref) > 10 * TOL


# --- serving: prefill, then ring decode through the engine --------------------------------


def serve_error(lm, ref, monkeypatch, n_requests=10, slots=3, prefix_len=P, control=None):
    """Serve requests through ServingEngine (3 slots, refills of 1-2 rows)
    and compare the logits of every prefill and of every decode step that
    fed a served token with the reference's full forward over the
    request's prefix and tokens. Each step's row is matched to its request
    by the (slot, ring start) its refill gave it. Returns the largest
    error and the number of positions compared, and with a `control`
    reference the largest distance of its logits from `ref`'s at those
    positions. Runs where the LM lies, in its dtype; on the card the
    engine replays the ring step as a CUDA graph, and the logits are read
    after each replay."""
    cfg, P = lm.cfg, prefix_len
    dev, dtype = lm.embed.device, lm.embed.dtype
    gen = torch.Generator().manual_seed(11)
    pool = torch.randn(n_requests + 1, P, cfg.hidden_size, generator=gen).to(dev, dtype)
    settings = GenerationSettings(max_new_tokens=10, top_p=0.9, repetition_penalty=1.2,
                                  eos_token_id=cfg.vocab_size - 1, stop_token_id=13,
                                  filter_method="sort")
    eng = ServingEngine(lm, cfg, prefix_len=P, settings=settings, slots=slots,
                        steps_per_sync=2, device=dev)
    placed, steps, prefills = [], [], []
    orig_refill, orig_init = ServingEngine._refill, ServingEngine._init
    prefill, step = lm.prefill, lm.decode_step_ring

    def refill(self, r, st, prefixes, q, new_max_len, n_real):
        orig_refill(self, r, st, prefixes, q, new_max_len, n_real)
        placed.append((q, prefixes[:n_real].clone(), st.start[q:q + n_real].clone()))

    def init(self, prefixes, live, max_len, seed):
        st = orig_init(self, prefixes, live, max_len, seed)
        placed.append((0, prefixes.clone(), st.start.clone()))
        return st

    def rec_prefill(embeds, cache, full_logits=False):
        out, cache = prefill(embeds, cache, full_logits)
        prefills.append((embeds.clone(), out[:, -1].clone()))
        return out, cache

    def rec_step(embed, cache, pos, start):
        out, cache = step(embed, cache, pos, start)
        steps.append((start.clone(), pos.clone(), out.clone()))
        return out, cache

    replay = _GraphStep.replay

    def rec_replay(self, tokens, cache, pos, start):
        cache = replay(self, tokens, cache, pos, start)
        steps.append((start.clone(), pos.clone(), self.logits.clone()))
        return cache

    monkeypatch.setattr(ServingEngine, "_refill", refill)
    monkeypatch.setattr(ServingEngine, "_init", init)
    monkeypatch.setattr(lm, "prefill", rec_prefill)
    if dev.type == "cuda":
        monkeypatch.setattr(_GraphStep, "replay", rec_replay)
    else:
        monkeypatch.setattr(lm, "decode_step_ring", rec_step)
    caps = np.random.default_rng(0).integers(3, 9, n_requests)
    res = eng.serve([Request(i, i + 1, max_length=int(c)) for i, c in enumerate(caps)],
                    seed=5, prefix_pool=pool)
    assert len(res) == n_requests and len({r["length"] for r in res.values()}) > 1

    def request_of(prefix):
        return next((i for i in range(n_requests) if torch.equal(prefix, pool[i + 1])), None)

    with torch.no_grad():
        want, ctrl = {}, 0.0
        for i, r in res.items():
            toks = torch.tensor(r["tokens"], device=dev)
            embeds = torch.cat([pool[i + 1][None], lm.embed_tokens(toks[None, :-1])], 1)
            want[i] = ref.logits(embeds)[0, P - 1:]  # row j predicts tokens[j]
            if control is not None:
                zc = control.logits(embeds)[0, P - 1:]
                ctrl = max(ctrl, float((zc - want[i]).abs().max()))
    occupant = {}  # (slot, ring start) -> request
    for q, prefixes, starts in placed:
        for j in range(len(prefixes)):
            i = request_of(prefixes[j])
            if i is not None:
                occupant[(q + j, int(starts[j]))] = i
    worst, n = 0.0, 0
    for prefixes, logits in prefills:
        for row in range(len(prefixes)):
            i = request_of(prefixes[row])
            if i is not None:
                worst = max(worst, float((logits[row].float() - want[i][0]).abs().max()))
                n += 1
    for start, pos, logits in steps:
        for s in range(len(start)):
            i = occupant.get((s, int(start[s])))
            j = int(pos[s]) - P + 1  # the token this step's logits predict
            if i is not None and j < len(res[i]["tokens"]):
                worst = max(worst, float((logits[s].float() - want[i][j]).abs().max()))
                n += 1
    return (worst, n) if control is None else (worst, n, ctrl)


def test_served_logits_match_the_reference(monkeypatch):
    lm = _model()
    worst, n = serve_error(lm, _reference(lm), monkeypatch)
    assert n >= 40  # every request's prefill and its decode steps
    assert worst < TOL


def test_fault_latent_ring_written_one_slot_off_fails(monkeypatch):
    lm = _model()
    ref = _reference(lm)
    orig = M.ring_layout

    def shifted(idx, a_len, start):
        slot, bias = orig(idx, a_len, start)
        return (slot + 1) % a_len, bias

    monkeypatch.setattr(M, "ring_layout", shifted)
    worst, _ = serve_error(lm, ref, monkeypatch)
    assert worst > 10 * TOL


def test_ring_step_at_a_device_index_matches_the_host_index():
    """The graph step's form: the ring index as a 0-d device tensor gives
    the host int's logits and writes the same ring slot."""
    lm = _model()
    x = torch.randn(3, 1, CFG.hidden_size, generator=torch.Generator().manual_seed(12))
    pos = torch.tensor([7, 9, 11])
    start = torch.tensor([0, 2, 4])
    with torch.no_grad():
        a = lm.init_cache(3, 8)
        a.kv.normal_(generator=torch.Generator().manual_seed(13))
        b = M.LatentCache(a.kv.clone(), a.index)
        za, _ = lm.decode_step_ring(x, a._replace(index=13), pos, start)
        zb, _ = lm.decode_step_ring(x, b._replace(index=13), pos, start,
                                    index=torch.tensor(13))
    assert torch.equal(za, zb) and torch.equal(a.kv, b.kv)
    assert M.DeepseekV3.graph_safe_ring_step


def test_expert_log_holds_each_calls_tokens_per_expert():
    lm = _model()
    log = lm.log_experts(4)
    x = torch.randn(2, 5, CFG.hidden_size, generator=torch.Generator().manual_seed(14))
    with torch.no_grad():
        lm(x)  # 2 MoE layers of 10 tokens, 2 experts each
        lm(x[:, :3])
    counts = log.read(0, int(log.mark()))
    assert counts.shape == (4, CFG.n_routed_experts)
    assert counts.sum(1).tolist() == [20, 20, 12, 12]
    with torch.no_grad():
        lm(x[:, :1])  # two more calls wrap the ring of 4
    assert log.read(4, 6).sum(1).tolist() == [4, 4]
    with pytest.raises(ValueError):
        log.read(0, 6)


def test_moonlight_tokenizer_is_refused_not_guessed():
    from clipcap_tpu_torch.tokenizers import create_tokenizer

    with pytest.raises(NotImplementedError, match="tiktoken"):
        create_tokenizer("moonlight", "unused")


def test_static_decode_matches_the_reference():
    """prefill then decode_step into a plain cache (the static engine's
    path) against the full forward."""
    lm = _model()
    ref = _reference(lm)
    x = torch.randn(2, 7, CFG.hidden_size, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want = ref.logits(x)
        cache = lm.init_cache(2, 8)
        got, cache = lm.prefill(x[:, :4], cache, full_logits=True)
        rows = [got]
        for t in range(4, 7):
            z, cache = lm.decode_step(x[:, t:t + 1], cache)
            rows.append(z[:, None])
    assert float((torch.cat(rows, 1) - want).abs().max()) < TOL


def test_registry_and_bundle_build_it():
    from clipcap_tpu_torch.core.config import CaptionerConfig, MapperConfig
    from clipcap_tpu_torch.lm.registry import family, get_lm, normalize_lm_type
    from clipcap_tpu_torch.models.bundle import CaptionerBundle

    assert normalize_lm_type("moonlight") == "deepseek_v3"
    assert get_lm("deepseek_v3") is M.DeepseekV3
    cap = CaptionerConfig(lm_type="moonlight", visual_encoder_type="none",
                          mapper=MapperConfig(dim_clip=16, dim_embedding=64, prefix_length=P,
                                              clip_length=P, num_layers=1, num_heads=4))
    bundle = CaptionerBundle.create(cap, CFG, None, device="cpu")
    prefix = bundle.project_prefix(torch.randn(2, 16))
    assert prefix.shape == (2, P, 64)
    settings = GenerationSettings(max_new_tokens=4, eos_token_id=511, filter_method="sort")
    res = bundle.make_serving_engine(settings, slots=2, steps_per_sync=2).serve(
        [Request(i, i % 2) for i in range(3)], prefix_pool=prefix)
    assert len(res) == 3
    fam = family("deepseek_v3")
    sd = {k: v.numpy() for k, v in bundle.lm.state_dict().items()}
    back = fam.state_dict(fam.params(sd, None))
    assert set(back) == set(sd)
    assert DeepseekV3Config.from_json(CFG.to_json()) == CFG


def test_checkpoint_round_trip_through_the_cli_loader(tmp_path):
    """A checkpoint of a DeepSeek-V3 captioner loads back through the CLIs'
    loader with the same logits."""
    from clipcap_tpu_torch.cli.loading import load_captioner
    from clipcap_tpu_torch.core.config import CaptionerConfig, MapperConfig
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.train.checkpoints import save_checkpoint

    cap = CaptionerConfig(lm_type="deepseek_v3", lm_variant="Moonlight-16B-A3B",
                          visual_encoder_type="none",
                          mapper=MapperConfig(dim_clip=16, dim_embedding=64, prefix_length=P,
                                              clip_length=P, num_layers=1, num_heads=4))
    model = Captioner(cap, CFG, device="cpu", seed=3)
    save_checkpoint(str(tmp_path / "ckpt"), model, cap, CFG)
    back, cap2, cfg2, _ = load_captioner(str(tmp_path / "ckpt"), device="cpu")
    assert cfg2 == CFG and cap2.lm_type == "deepseek_v3"
    tokens = torch.randint(1, 512, (2, 6))
    feats = torch.randn(2, 16)
    with torch.no_grad():
        torch.testing.assert_close(back(tokens, feats), model(tokens, feats))


def test_hf_state_dict_converts_to_the_ports_names():
    """DeepseekV3ForCausalLM's names (gate and up apart, experts one by one)
    come back as the port's state dict."""
    lm = _model()
    sd = {k: v.detach().numpy() for k, v in lm.state_dict().items()}
    hf = {"model.embed_tokens.weight": sd["embed"], "model.norm.weight": sd["norm.weight"],
          "lm_head.weight": sd["head.weight"]}
    attn = {"q_proj": "q_proj", "kv_a": "kv_a_proj_with_mqa", "kv_b": "kv_b_proj",
            "o_proj": "o_proj"}
    for i in range(CFG.num_hidden_layers):
        src, m = f"layers.{i}.", f"model.layers.{i}."
        hf[m + "input_layernorm.weight"] = sd[src + "attn_norm.weight"]
        hf[m + "post_attention_layernorm.weight"] = sd[src + "mlp_norm.weight"]
        hf[m + "self_attn.kv_a_layernorm.weight"] = sd[src + "attn.kv_norm.weight"]
        for ours, theirs in attn.items():
            hf[f"{m}self_attn.{theirs}.weight"] = sd[f"{src}attn.{ours}.weight"]
        if i < CFG.first_k_dense_replace:
            gate, up = np.split(sd[src + "mlp.gate_up.weight"], 2)
            hf.update({m + "mlp.gate_proj.weight": gate, m + "mlp.up_proj.weight": up,
                       m + "mlp.down_proj.weight": sd[src + "mlp.down.weight"]})
            continue
        hf[m + "mlp.gate.weight"] = sd[src + "mlp.router.weight"]
        hf[m + "mlp.gate.e_score_correction_bias"] = sd[src + "mlp.router_bias"]
        for j in range(CFG.n_routed_experts):
            gate, up = np.split(sd[src + "mlp.experts.gate_up"][j], 2)
            hf.update({f"{m}mlp.experts.{j}.gate_proj.weight": gate,
                       f"{m}mlp.experts.{j}.up_proj.weight": up,
                       f"{m}mlp.experts.{j}.down_proj.weight": sd[src + "mlp.experts.down"][j]})
        gate, up = np.split(sd[src + "mlp.shared.gate_up.weight"], 2)
        hf.update({m + "mlp.shared_experts.gate_proj.weight": gate,
                   m + "mlp.shared_experts.up_proj.weight": up,
                   m + "mlp.shared_experts.down_proj.weight": sd[src + "mlp.shared.down.weight"]})
    got = M.from_hf_state_dict(hf, CFG)
    assert set(got) == set(sd)
    assert all(np.array_equal(got[k], sd[k]) for k in sd)
