"""Port parity for ``repro_torch.dist.act_sharding`` against
``repro.dist.act_sharding``: each kind's spec and the divisibility
fallback (``_Policy.fit``) equal the reference's ``PartitionSpec`` entries
on shapes that do and do not divide, with and without axis sizes; the
policy stack nests, a nested policy without a recorder recording into
the enclosing one's; ``strip_leading`` and ``constrain_tree`` are
identities with no policy; and the models' constraint points: for a
reduced config of each family in train, prefill and decode, under
``act_policy(("data",), "model", {"data": 2, "model": 2})``, the distinct
``(kind, shape, spec)`` triples in order of first appearance equal the
reference's. The reference's are recorded by wrapping its ``_spec_for``
(with ``jax.lax.with_sharding_constraint`` an identity, there being no
mesh); it traces its scanned period body once where the port runs each
layer, hence distinct triples. The launch step factories' own
``dp``/``tp``/``sizes`` policies record the same triples into an
enclosing recorder."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.dist import act_sharding as jact
from repro.models import model as jmodel
from repro_torch.configs.registry import get_config
from repro_torch.dist import act_sharding as tact
from repro_torch.models import model as tmodel

KINDS = ("act", "ffn", "heads4", "hd_tp", "moe_tokens", "logits")
SHAPES = [(), (8,), (8, 6), (6, 5, 12), (8, 3, 4, 16), (5, 7, 6, 10),
          (12, 4, 9)]
POLICIES = [
    (("data",), "model", {"data": 2, "model": 2}),
    (("data",), "model", {"data": 4, "model": 3}),
    (("pod", "data"), ("model",), {"pod": 2, "data": 2, "model": 4}),
    (("pod", "data"), "model", {"pod": 3, "data": 2, "model": 2}),
    (("data",), "model", None),
    (None, "model", {"model": 2}),
    ("data", None, {"data": 2}),
]
FAMILIES = ["qwen2-0.5b", "arctic-480b", "deepseek-v2-236b",
            "jamba-v0.1-52b", "rwkv6-3b", "qwen2-vl-2b", "whisper-base"]
POLICY = (("data",), "model", {"data": 2, "model": 2})


@pytest.mark.parametrize("dp,tp,sizes", POLICIES)
def test_spec_for_and_fit_match_reference(dp, tp, sizes):
    jp, tpol = jact._Policy(dp, tp, sizes), tact._Policy(dp, tp, sizes)
    for kind, shape in itertools.product(KINDS, SHAPES):
        assert tact._spec_for(kind, shape, tpol) == \
            tuple(jact._spec_for(kind, shape, jp)), (kind, shape)
    for axes, dim in itertools.product(
            [(), ("data",), ("model",), ("pod", "data"), ("data", "model"),
             ("pod", "data", "model")], [1, 2, 3, 4, 6, 12, 7]):
        assert tpol.fit(axes, dim) == jp.fit(axes, dim), (axes, dim)


def test_policy_stack_nests():
    assert tact.current_policy() is None
    with tact.act_policy("data", "model", {"data": 2}) as outer:
        assert tact.current_policy() is outer
        assert outer.dp == ("data",) and outer.tp == ("model",)
        with tact.act_policy(("pod", "data"), None) as inner:
            assert tact.current_policy() is inner
            assert inner.tp == () and inner.sizes is None
        assert tact.current_policy() is outer
    assert tact.current_policy() is None


def test_nested_policy_records_into_the_enclosing_recorder():
    """A policy with no recorder of its own records its own decisions
    into the enclosing policy's recorder; one with its own keeps them."""
    x = torch.zeros(4, 3, 6)
    outer_rec, inner_rec = [], []
    with tact.act_policy("data", None, {"data": 4}, recorder=outer_rec):
        with tact.act_policy(None, "model", {"model": 3}) as inner:
            assert inner.recorder is outer_rec
            tact.constrain(x, "ffn")
            with tact.act_policy("data", "model", {"data": 2, "model": 2},
                                 recorder=inner_rec):
                tact.constrain(x, "ffn")
        tact.constrain(x, "ffn")
    assert outer_rec == [("ffn", (4, 3, 6), (None, None, "model")),
                         ("ffn", (4, 3, 6), ("data", None, None))]
    assert inner_rec == [("ffn", (4, 3, 6), ("data", None, "model"))]


def test_identities_without_a_policy():
    x = torch.randn(2, 3, 4)
    assert tact.constrain(x, "act") is x
    specs = {"a": (None, "model"), "b": {"c": ((("model", "data")), None,
                                              None)}}
    assert tact.strip_leading(specs) == {"a": ("model",),
                                         "b": {"c": (None, None)}}
    assert jax.tree.map(tuple, jact.strip_leading(
        {"a": jax.sharding.PartitionSpec(None, "model"),
         "b": {"c": jax.sharding.PartitionSpec(("model", "data"), None,
                                               None)}}),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)) == \
        tact.strip_leading(specs)
    tree = {"w": torch.randn(4, 4), "n": {"scale": torch.ones(4)}}
    out = tact.constrain_tree(tree, {"w": (None, "data"),
                                     "n": {"scale": (None,)}})
    assert out is tree
    # a policy without a placement leaves constrain_tree the identity too
    with tact.act_policy(*POLICY):
        assert tact.constrain_tree(tree, {"w": (None, "data")}) is tree
        assert tact.constrain(x, "ffn") is x


# ---------------------------------------------------------------------------
# the models' constraint points


def _dedupe(triples):
    seen, out = set(), []
    for t in triples:
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def _inputs(cfg, mode, seed=0):
    rng = np.random.default_rng(seed)
    b = 2
    s = 1 if mode == "decode" else 8
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    enc = None
    if cfg.encoder_decoder and mode != "decode":
        enc = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return tokens, enc


def _reference_triples(name, mode, monkeypatch):
    jcfg = jax_config(name).reduced()
    jp = jmodel.init_model(jax.random.PRNGKey(0), jcfg, max_pos=64)
    tokens, enc = _inputs(jcfg, mode)
    rec = []
    spec_for = jact._spec_for

    def recording(kind, shape, pol):
        spec = spec_for(kind, shape, pol)
        rec.append((kind, tuple(shape), tuple(spec)))
        return spec

    monkeypatch.setattr(jact, "_spec_for", recording)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: x)
    kw = {}
    if mode == "decode":
        kw = dict(cache=jmodel.init_cache(jcfg, 2, 12),
                  cache_index=jnp.asarray(5, jnp.int32))
    elif enc is not None:
        kw = dict(enc_embed=jnp.asarray(enc))
    with jact.act_policy(*POLICY):
        jax.make_jaxpr(lambda p, t: jmodel.apply_model(
            p, t, jcfg, mode=mode, remat_policy="none", **kw))(
                jp, jnp.asarray(tokens))
    return _dedupe(rec)


def _port_triples(name, mode):
    cfg = get_config(name).reduced()
    tp = tmodel.init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu", max_pos=64)
    tokens, enc = _inputs(cfg, mode)
    kw = {}
    if mode == "decode":
        kw = dict(cache=tmodel.init_cache(cfg, 2, 12, device="cpu"),
                  cache_index=torch.tensor(5, dtype=torch.int32))
    elif enc is not None:
        kw = dict(enc_embed=torch.from_numpy(enc))
    rec = []
    with tact.act_policy(*POLICY, recorder=rec), torch.no_grad():
        tmodel.apply_model(tp, torch.from_numpy(tokens), cfg, mode=mode,
                           **kw)
    return _dedupe(rec)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", FAMILIES)
def test_constraint_points_match_reference(name, mode, monkeypatch):
    ours = _port_triples(name, mode)
    ref = _reference_triples(name, mode, monkeypatch)
    assert ours == ref
    assert ours, "no constraint point reached"


def _step_triples(name, mode):
    """The triples the launch step factories record, under their own
    ``dp``/``tp``/``sizes`` policy, into an enclosing recorder whose own
    policy would decide otherwise (a dry run's)."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    cfg = get_config(name).reduced()
    params = tmodel.init_model(torch.Generator().manual_seed(0), cfg,
                               device="cpu", max_pos=64)
    tokens, _ = _inputs(cfg, mode)
    tokens = torch.from_numpy(tokens)
    dp, tp, sizes = POLICY
    rec = []
    with tact.act_policy(None, None, recorder=rec):
        if mode == "prefill":
            tserve.make_prefill_step(cfg, dp=dp, tp=tp, sizes=sizes)(
                params, {"tokens": tokens})
        elif mode == "decode":
            tserve.make_decode_step(cfg, dp=dp, tp=tp, sizes=sizes)(
                params, {"tokens": tokens,
                         "cache": tmodel.init_cache(cfg, 2, 12,
                                                    device="cpu"),
                         "pos": torch.tensor(5, dtype=torch.int32)})
        else:
            tc = ttrain.TrainConfig(remat_policy="none")
            state = ttrain.init_state(torch.Generator().manual_seed(0), cfg,
                                      tc, max_pos=64, device="cpu")
            ttrain.make_train_step(cfg, tc, dp=dp, tp=tp, sizes=sizes)(
                state, {"tokens": tokens, "targets": tokens,
                        "weights": torch.ones(tokens.shape)})
    return _dedupe(rec)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_step_factories_record_into_an_outer_recorder(mode, monkeypatch):
    """``make_train_step`` / ``make_prefill_step`` / ``make_decode_step``
    with ``dp``, ``tp`` and ``sizes`` reach the models' constraint points
    under their own policy: an enclosing recorder gets the reference's
    triples for that policy."""
    ours = _step_triples("qwen2-0.5b", mode)
    assert ours == _reference_triples("qwen2-0.5b", mode, monkeypatch)
    assert ours and all(spec[0] == "data" for _, _, spec in ours)
