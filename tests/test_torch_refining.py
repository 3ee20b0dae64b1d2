"""The refining models of the port (detzero_tpu_torch.models.refining)
against the reference's flax GRM, PRM and CRM on the CPU, at tiny widths
(tests/torch_refine_cases.py), float32 both, on converted weights:

  * forward within 1e-5 * max(|ref|, 1), padded PRM queries and a GRM
    track with no points included; fully-masked attention rows finite and
    equal to flax's uniform rows;
  * the batch loss and every gradient leaf against jax.value_and_grad of
    tools/train_refine.py's make_loss_fn, within 1e-4 relative;
  * decode: sizes and centers within 1e-5, heading bins and anchors equal
    wherever the top two logits differ by more than 1e-4; target
    encode/decode equal to the reference's, the heading bin edges
    included (the size residual's log within one float32 ulp and the
    decoded size's exp and product within two: XLA's and torch's
    transcendentals round differently);
  * convert_refiner's refusals and to_flax's round trip;
  * BatchedRefiner at batch sizes 1, 3 and 8 equal within 1e-6
    relative, and to the reference's within 1e-5;
  * TTA expand and fuse equal to the reference's (1e-6).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as nn

from detzero_tpu.models import refining as R
from detzero_tpu.models.refining import target_assign as ref_ta
from detzero_tpu.models.refining import tta as ref_tta
from detzero_tpu.models.refining.batched import BatchedRefiner as RefBatched
from detzero_tpu_torch.convert import convert_refiner, to_flax
from detzero_tpu_torch.core.registry import REFINE_MODULES
from detzero_tpu_torch.models import refining as P
from detzero_tpu_torch.models.layers import MultiHeadDotProductAttention
from detzero_tpu_torch.models.refining import target_assign as ta
from detzero_tpu_torch.models.refining import tta
from detzero_tpu_torch.models.refining.batched import BatchedRefiner
from tools.train_refine import make_loss_fn

import torch_refine_cases as cases

torch.set_num_threads(1)
KINDS = ("grm", "prm", "crm")


def ref_model(kind):
    if kind == "grm":
        return R.GeometryTransformer(d_model=cases.D_MODEL,
                                     n_heads=cases.HEADS)
    if kind == "prm":
        return R.PositionTransformer(d_model=cases.D_MODEL,
                                     n_heads=cases.HEADS,
                                     mem_points=cases.NM)
    return R.ConfidencePointNet(d_model=cases.D_MODEL)


def port_model(kind, variables=None):
    kw = {"d_model": cases.D_MODEL, "device": "cpu"}
    if kind != "crm":
        kw["n_heads"] = cases.HEADS
    if kind == "grm":
        kw["anchors"] = cases.ANCHORS
    m = REFINE_MODULES.get(cases.NAMES[kind])(**kw)
    if variables is not None:
        m.load_state_dict(convert_refiner(variables, m), strict=True)
    return m


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    kind = request.param
    jm = ref_model(kind)
    v = cases.flax_variables(jm, kind)
    return kind, jm, v, port_model(kind, v)


def ref_forward(jm, v, kind, batch):
    args = [batch[k] for k in cases.INPUTS[kind]]
    return jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda *a: jm.apply(v, *a)))(*args))


def port_forward(model, kind, batch):
    with torch.no_grad():
        return model(*(torch.from_numpy(batch[k])
                       for k in cases.INPUTS[kind]))


def close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1.0)


def test_forward(pair):
    kind, jm, v, model = pair
    batch = cases.BATCHES[kind](1)
    ref = ref_forward(jm, v, kind, batch)
    got = port_forward(model, kind, batch)
    assert set(ref) == set(got)
    for k in ref:
        g = got[k].numpy()
        assert np.isfinite(g).all(), k
        assert close(ref[k], g, 1e-5), (k, np.abs(ref[k] - g).max())


def test_fully_masked_attention_rows():
    """flax's masked logits are finfo(float32).min: a query row with every
    key masked attends uniformly over all keys; the port gives those rows,
    finite (not scaled_dot_product_attention's NaN)."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 5, 16).astype(np.float32)
    kv = rng.randn(2, 7, 16).astype(np.float32)
    qm = np.array([[1, 1, 0, 1, 0], [0, 0, 0, 0, 0]], bool)
    km = np.array([[1, 0, 1, 1, 0, 1, 1], [1, 1, 1, 1, 1, 1, 1]], bool)
    mask = qm[:, None, :, None] & km[:, None, None, :]
    att = nn.MultiHeadDotProductAttention(num_heads=2, qkv_features=16)
    v = att.init(jax.random.PRNGKey(0), q, kv, kv, mask=mask)
    v = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(
        *np.shape(a)).astype(np.float32), v)
    ref = np.asarray(att.apply(v, q, kv, kv, mask=mask))
    mod = MultiHeadDotProductAttention(16, 2, 16)
    mod.load_state_dict(convert_refiner(v, mod), strict=True)
    with torch.no_grad():
        got = mod(*map(torch.from_numpy, (q, kv, kv)),
                  mask=torch.from_numpy(mask)).numpy()
        uniform = mod.out(mod.value(torch.from_numpy(kv)).mean(
            1, keepdim=True)).numpy()
    assert np.isfinite(got).all()
    assert close(ref, got, 1e-5)
    full = ~qm
    assert full.sum() == 7
    for b, i in zip(*np.nonzero(full)):
        assert np.abs(got[b, i] - uniform[b, 0]).max() <= 1e-5
        assert np.abs(ref[b, i] - uniform[b, 0]).max() <= 1e-5


def test_pointnet_masked_pool():
    """The masked max-pool: masked points pool as -inf, and a pool with no
    valid point (sample 1, row 2) is 0, as the reference's; within 1e-5."""
    from detzero_tpu.models.refining.modules import PointNetEncoder as RefPN
    from detzero_tpu_torch.models.refining.modules import PointNetEncoder

    rng = np.random.RandomState(4)
    pts = rng.randn(2, 3, 9, 11).astype(np.float32)
    mask = rng.rand(2, 3, 9) > 0.4
    mask[1, 2] = False
    enc = RefPN((16, 32))
    v = enc.init(jax.random.PRNGKey(1), pts, mask)
    v = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(
        *np.shape(a)).astype(np.float32), v)
    ref = np.asarray(enc.apply(v, pts, mask)[0])
    mod = PointNetEncoder(11, (16, 32))
    mod.load_state_dict(convert_refiner(v, mod), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    assert (got[1, 2] == 0).all() and (ref[1, 2] == 0).all()
    assert close(ref, got, 1e-5)


def batch_loss_and_grads(kind, jm, v, batch):
    loss_fn = make_loss_fn(cases.ref_cfg(kind), jm)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: loss_fn({"params": p}, batch), has_aux=True))(v["params"])
    return float(loss), jax.tree.map(np.asarray, g)


def test_loss_and_gradients(pair):
    kind, jm, v, model = pair
    batch = cases.BATCHES[kind](2)
    loss_ref, g_ref = batch_loss_and_grads(kind, jm, v, batch)
    model.zero_grad()
    loss, aux = model.loss(**{k: torch.from_numpy(a)
                              for k, a in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - loss_ref) <= 1e-4 * abs(loss_ref)
    assert all(a.shape == (len(batch["query_pts"]),) for a in aux.values())
    got = to_flax({n: p.grad for n, p in model.named_parameters()})["params"]
    ref_leaves = jax.tree_util.tree_leaves_with_path(g_ref)
    assert len(ref_leaves) == len(jax.tree.leaves(got))
    for path, a in ref_leaves:
        node = got
        for part in path:
            node = node[part.key]
        assert close(a, node, 1e-4), (jax.tree_util.keystr(path),
                                      np.abs(a - node).max())


def test_decode(pair):
    kind, jm, v, model = pair
    batch = cases.BATCHES[kind](4)
    ref = ref_forward(jm, v, kind, batch)
    got = port_forward(model, kind, batch)
    if kind == "grm":
        want = np.asarray(jax.vmap(lambda p: R.grm_decode(
            p, cases.ANCHORS))(ref))
        dec = P.grm_decode(got, cases.ANCHORS).numpy()
        top = np.sort(ref["anchor_logits"], -1)
        clear = (top[..., -1] - top[..., -2] > 1e-4).all()
        assert clear and np.abs(want - dec).max() <= 1e-5
        per = P.grm_decode(got, np.repeat(cases.ANCHORS[None], len(dec), 0))
        assert np.array_equal(per.numpy(), dec)
    elif kind == "prm":
        qb = batch["query_boxes"]
        c_ref, h_ref = jax.vmap(R.prm_decode)(ref, qb)
        c, h = P.prm_decode(got, torch.from_numpy(qb))
        assert np.abs(np.asarray(c_ref) - c.numpy()).max() <= 1e-5
        top = np.sort(ref["heading_logits"][:, -1], -1)
        clear = top[..., -1] - top[..., -2] > 1e-4
        assert clear.mean() > 0.9
        b_ref = np.argmax(ref["heading_logits"][:, -1], -1)
        b_got = np.argmax(got["heading_logits"][:, -1].numpy(), -1)
        assert np.array_equal(b_ref[clear], b_got[clear])
        assert np.abs(np.asarray(h_ref) - h.numpy())[clear].max() <= 1e-5
    else:
        want = np.asarray(jax.vmap(R.crm_decode)(ref))
        assert np.abs(want - P.crm_decode(got).numpy()).max() <= 1e-5


def test_size_encode_decode_equal():
    rng = np.random.RandomState(5)
    gt = (cases.ANCHORS[rng.randint(3, size=64)]
          * rng.uniform(0.5, 1.5, (64, 3))).astype(np.float32)
    gt[:4] = (cases.ANCHORS[0] + cases.ANCHORS[1]) / 2   # ties: first index
    gt[4] = 0.0
    cls_r, res_r = ref_ta.encode_size(jnp.asarray(gt), cases.ANCHORS)
    cls, res = ta.encode_size(torch.from_numpy(gt), cases.ANCHORS)
    assert np.array_equal(np.asarray(cls_r), cls.numpy())
    np.testing.assert_array_max_ulp(np.asarray(res_r), res.numpy(), 1)
    logits = rng.randn(64, 3).astype(np.float32)
    logits[:3] = 0.5                                   # ties: first index
    resid = rng.randn(64, 3, 3).astype(np.float32) * 3
    want = ref_ta.decode_size(logits, resid, cases.ANCHORS)
    got = ta.decode_size(torch.from_numpy(logits), torch.from_numpy(resid),
                         cases.ANCHORS)
    np.testing.assert_array_max_ulp(np.asarray(want), got.numpy(), 2)
    # the anchor each size decodes from: the first of tied logits
    base = ta.decode_size(torch.from_numpy(logits), torch.zeros(64, 3, 3),
                          cases.ANCHORS)
    assert np.array_equal(base.numpy(), cases.ANCHORS[np.argmax(logits, 1)])


def test_heading_encode_decode_equal():
    """The 12 bins' edges, their float32 neighbours, +-pi and beyond."""
    period = np.float32(2 * np.pi / 12)
    edges = (np.arange(-24, 25) * period - np.float32(np.pi)) \
        .astype(np.float32)
    h = np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf)),
                        np.nextafter(edges, np.float32(np.inf)),
                        np.float32([np.pi, -np.pi, 0, 7.5, -9.25]),
                        np.random.RandomState(2).uniform(-10, 10, 200)
                        .astype(np.float32)]).astype(np.float32)
    b_r, r_r = ref_ta.encode_heading(jnp.asarray(h))
    b, r = ta.encode_heading(torch.from_numpy(h))
    assert np.array_equal(np.asarray(b_r), b.numpy())
    assert np.array_equal(np.asarray(r_r), r.numpy())
    logits = np.eye(12, dtype=np.float32)[np.asarray(b_r)] * 5
    logits[:5] = 1.0                                   # ties: first index
    res = np.random.RandomState(3).randn(len(h), 12).astype(np.float32)
    want = ref_ta.decode_heading(logits, res)
    got = ta.decode_heading(torch.from_numpy(logits), torch.from_numpy(res))
    assert np.array_equal(np.asarray(want), got.numpy())
    ious = np.float32([-1, 0, 0.35, 0.36, 0.69, 0.7, 1.0, 0.2])
    for want, got in zip(ref_ta.confidence_labels(jnp.asarray(ious), 0.35,
                                                  0.7),
                         ta.confidence_labels(torch.from_numpy(ious), 0.35,
                                              0.7)):
        assert np.array_equal(np.asarray(want), got.numpy())


def test_convert_refiner_refusals_and_round_trip(pair):
    kind, _, v, model = pair
    back = to_flax(model.state_dict())
    assert jax.tree.structure(back["params"]) == jax.tree.structure(
        v["params"])
    for a, b in zip(jax.tree.leaves(v["params"]),
                    jax.tree.leaves(back["params"])):
        assert np.array_equal(a, b)
    bad = jax.tree.map(lambda a: a, v)
    bad["params"]["extra"] = {"kernel": np.zeros((2, 3, 4, 5), np.float32)}
    with pytest.raises(ValueError, match="no conversion rule"):
        convert_refiner(bad, model)
    bad = {"params": dict(v["params"])}
    bad["params"]["stray"] = {"kernel": np.zeros((3, 4), np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        convert_refiner(bad, model)
    bad = {"params": dict(v["params"])}
    bad["params"].pop(next(iter(bad["params"])))
    with pytest.raises(ValueError, match="unfilled"):
        convert_refiner(bad, model)


@pytest.mark.parametrize("kind", KINDS)
def test_batched_refiner_batch_sizes(kind):
    """Results equal at batch sizes 1, 3 and 8 (the last chunk padded),
    and to the reference's BatchedRefiner within 1e-5."""
    jm = ref_model(kind)
    v = cases.flax_variables(jm, kind)
    model = port_model(kind, v)
    batch = cases.BATCHES[kind](6, b=7)
    samples = [{k: batch[k][i] for k in cases.INPUTS[kind]}
               for i in range(7)]
    if kind == "grm":
        for s in samples:
            s["anchors"] = cases.ANCHORS
    runs = [BatchedRefiner(model, kind, bs).run(samples) for bs in (1, 3, 8)]
    ref = RefBatched(jm, v, kind, batch_size=4).run(samples)
    for i in range(7):
        leaves = [jax.tree.leaves(r[i]) for r in runs]
        for a, b in zip(jax.tree.leaves(ref[i]), leaves[0]):
            assert np.abs(np.asarray(a) - b).max() <= 1e-5
        for other in leaves[1:]:
            for a, b in zip(leaves[0], other):
                assert close(a, b, 1e-6)


def test_tta_expand_and_fuse():
    rng = np.random.RandomState(9)
    g = cases.grm_batch(0, 1)
    s = {k: g[k][0] for k in cases.INPUTS["grm"]}
    want = ref_tta.grm_tta_expand(s)
    got = tta.grm_tta_expand(s)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert np.abs(np.asarray(want[k], np.float32)
                      - np.asarray(got[k], np.float32)).max() <= 1e-6, k
    sizes = rng.rand(len(tta.GRM_DEFAULT_VARIANTS), 3).astype(np.float32) + 1
    assert np.abs(np.asarray(ref_tta.grm_tta_fuse(sizes))
                  - tta.grm_tta_fuse(sizes)).max() <= 1e-6
    p = cases.prm_batch(0, 1)
    s = {k: p[k][0] for k in cases.INPUTS["prm"]}
    want = ref_tta.prm_tta_expand(s)
    got = tta.prm_tta_expand(s)
    for k in want:
        assert np.abs(np.asarray(want[k], np.float32)
                      - np.asarray(got[k], np.float32)).max() <= 1e-6, k
    k = len(tta.PRM_DEFAULT_VARIANTS)
    c = rng.randn(k, cases.T, 3).astype(np.float32)
    h = rng.uniform(-np.pi, np.pi, (k, cases.T)).astype(np.float32)
    for a, b in zip(ref_tta.prm_tta_fuse(jnp.asarray(c), jnp.asarray(h)),
                    tta.prm_tta_fuse(c, h)):
        assert np.abs(np.asarray(a) - b).max() <= 1e-6
