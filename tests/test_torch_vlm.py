"""Port parity for the vision-prefix decoder (internvl2) family on the
group ``ServeEngine``.

* Model level: one jitted reference ``prefill`` (seeded patch embeddings
  before the tokens; positions and ``cache["pos"]`` count them) and 4
  ``decode_step``s of reduced internvl2 (float32 compute, packed cache)
  against the port's on the same weights: tokens equal, logits within the
  engine bar of ``tests/test_torch_model.py`` (the residual output
  projections scaled by 8, so that tokens vary). The engine-level
  comparison with the reference's ``ServeEngine`` is left out (36 s of its
  CPU time); the engine's batching is held on the dense, MoE and SSM
  families.
* Prepared weights bitwise against the reference's ``prepare_params(...,
  dims=param_dims(cfg))``.
* Inside the port: the group engine (zero patch embeddings, as the
  reference's stub) == the model-level loop, bitwise; a prefill of T
  tokens and a decode step == a prefill of T + 1; the cache must hold the
  prefix: ``warmup`` and ``run`` refuse a bucket that fits ``max_len``
  only without it, naming the prefix.
* ``chip_smoke``'s B1 shapes (the projections over prefix + prompt rows)
  and launch counts.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import param_dims as r_param_dims  # noqa: E402
from repro.quant import prepared as rprep  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.models import init_cache, prefill  # noqa: E402
from repro_torch.quant import prepare_params  # noqa: E402

from test_torch_encdec import scale_out  # noqa: E402
from test_torch_model import (  # noqa: E402
    check_model_parity, check_prefill_then_decode, engine_matches_model_loop,
    family_cfgs, family_weights, prepared_leaves)
from test_torch_moe import (  # noqa: E402
    check_family_b1_shapes, check_group_launches)

ARCH = "internvl2-2b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_prefill_and_decode_match_reference():
    toks = check_model_parity(ARCH, edit=scale_out)
    assert len({int(t) for t in toks.reshape(-1)}) > 2


def test_prepared_weights_bitwise_with_reference_dims():
    tcfg, rcfg = family_cfgs(ARCH)
    rparams, np_params = family_weights(tcfg, rcfg)
    rp = rprep.prepare_params(rparams, rcfg.quant, dims=r_param_dims(rcfg))
    tp = prepare_params(params_from_numpy(np_params), tcfg.quant)
    r_pw, t_pw = prepared_leaves(rp), prepared_leaves(tp)
    assert set(r_pw) == set(t_pw) and len(t_pw) == 7
    for path, a in r_pw.items():
        np.testing.assert_array_equal(np.asarray(a.codes),
                                      t_pw[path].codes.numpy())
        np.testing.assert_array_equal(np.asarray(a.scale),
                                      t_pw[path].scale.numpy())


def test_engine_matches_model_loop():
    eng, reqs = engine_matches_model_loop(ARCH)
    assert eng.max_len == eng.cfg.vision_prefix + 12


def test_prefill_then_decode_matches_longer_prefill():
    check_prefill_then_decode(ARCH)


def test_prefix_counts_in_positions_and_cache():
    """The prefix takes cache positions 0..P-1: after a prefill of T tokens
    ``pos`` is P + T and the packed planes hold P + T written entries
    (random patch embeddings: the engine's zero stub gives zero keys,
    whose scale is zero)."""
    tcfg, _ = family_cfgs(ARCH)
    P, T = tcfg.vision_prefix, 5
    eng = ServeEngine(tcfg, batch=2, max_len=P + T + 3, device="cpu")
    batch = eng._make_batch(np.ones((2, T), np.int64))
    assert tuple(batch["vision_embeds"].shape) == (2, P, tcfg.d_model)
    assert batch["vision_embeds"].dtype == torch.bfloat16
    assert not batch["vision_embeds"].any()
    batch["vision_embeds"] = torch.randn(2, P, tcfg.d_model)
    _, cache = prefill(eng.params, tcfg, batch,
                       init_cache(tcfg, 2, P + T + 3))
    assert cache["pos"] == P + T
    written = (cache["k_scale"][0, 0, 0] > 0).sum().item()
    assert written == P + T


def test_max_len_check_counts_the_prefix():
    tcfg, _ = family_cfgs(ARCH)
    P = tcfg.vision_prefix
    eng = ServeEngine(tcfg, batch=2, max_len=12, device="cpu")
    assert P + 8 + 1 > 12 >= 8 + 1
    with pytest.raises(ValueError, match=f"{P}-token vision prefix"):
        eng.warmup([8], max_new=1)
    reqs = [Request(rid=0, prompt=np.arange(1, 9), max_new_tokens=2)]
    with pytest.raises(ValueError, match="vision prefix"):
        eng.run(reqs)
    # warmup's 2 decode steps fill the cache; a run of 2 new tokens takes
    # one decode step
    ok = ServeEngine(tcfg, batch=2, max_len=P + 8 + 2, device="cpu")
    assert ok.warmup([8], max_new=2) == [8]
    with pytest.raises(ValueError, match="vision prefix"):
        ok.warmup([8], max_new=3)
    tight = ServeEngine(tcfg, batch=2, max_len=P + 8 + 1, device="cpu")
    tight.run(reqs)
    assert len(reqs[0].out_tokens) == 2


def test_chip_smoke_checks_every_vlm_b1_shape():
    check_family_b1_shapes(reduced_config(ARCH))


def test_chip_smoke_predicts_vlm_launches():
    """The prefix + prompt rows (8 + 32) in 16-key chunks: 3 score / value
    pairs a layer."""
    check_group_launches(dataclasses.replace(reduced_config(ARCH),
                                             attn_chunk=16))
