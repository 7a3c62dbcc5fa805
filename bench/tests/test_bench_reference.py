"""The plain references against the port's CPU path at small sizes, on
the same weights and inputs (the references import nothing of the port;
these tests do, to hold the two against each other)."""
import numpy as np
import pytest
import torch

from bench import common, plain
from bench.drivers.route import load_weights

torch.backends.cuda.matmul.allow_tf32 = False


def _enc_cfg():
    return common.config(common.manifest(), "knn100-exact-1m")["encoder"]


def test_tokenizer_matches_the_port():
    from repro_torch.serving.encoder import hash_tokenize
    ref = common.reference("knn100-exact-1m")
    texts = ["Algebra proofs question", "", "a " * 80, "t1w2 c3 T1W2"]
    got = ref.tokenize(texts, 8192, 64)
    want = np.stack([hash_tokenize(t) for t in texts])
    assert (got == want).all()


def test_encoder_matches_the_port():
    from repro_torch.models import model as M
    from repro_torch.serving.encoder import ENCODER_CFG, QueryEncoder
    ref = common.reference("knn100-exact-1m")
    e = _enc_cfg()
    g = torch.Generator().manual_seed(3)
    w = plain.make_weights(ref.encoder_specs(e), g, "cpu")
    lm = M.LM(ENCODER_CFG, "cpu")
    load_weights(lm, w)
    enc = QueryEncoder(params=lm, device="cpu")
    texts = ["python programming question %d" % i for i in range(5)] + \
        ["one", "w " * 70]
    got = enc.embed_texts(texts)
    want = ref.embed(w, e, ref.tokenize(texts, e["vocab_size"], 64), "cpu",
                     plain.Precision()).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_topk_and_tail_match_the_port():
    from repro_torch.core.dataset import RoutingDataset
    from repro_torch.core.routers import make_router
    ref = common.reference("knn100-exact-1m")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 32)).astype(np.float32)
    S = rng.uniform(size=(3000, 2)).astype(np.float32)
    C = np.tile([[0.001, 0.01]], (3000, 1)).astype(np.float32)
    ds = RoutingDataset("t", X, S, C, ["a", "b"], train_idx=np.arange(3000),
                        val_idx=np.zeros(0, int), test_idx=np.zeros(0, int))
    r = make_router("knn100", device="cpu").fit(ds)
    q = rng.normal(size=(40, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    lam = np.resize(np.float32([0, 0.5, 2, 100]), 40)
    choice, s_hat, c_hat, kth, agree = r.serve_fused(q, lam)
    sims, idx = ref.topk(torch.from_numpy(q), X, 100, plain.Precision(),
                         block=700)
    ch, sh, chat, ag, _ = ref.tail(idx[:, :100], torch.from_numpy(S),
                                   torch.from_numpy(C), torch.from_numpy(lam))
    assert np.abs(kth - sims[:, 99].numpy()).max() < 1e-5
    clear = (sims[:, 99] - sims[:, 100]).numpy() > 1e-5
    assert clear.mean() > 0.8
    assert np.abs(s_hat - sh.numpy())[clear].max() < 1e-5
    assert np.abs(c_hat - chat.numpy())[clear].max() < 1e-6
    assert np.abs(agree - ag.numpy())[clear].max() < 1e-6
    assert (choice == ch.numpy())[clear].all()


def _small_lm():
    from bench.tests.conftest import SMALL
    c = dict(common.config(common.manifest(), "h2o-danube-1.8b"))
    c.update(SMALL["h2o-danube-1.8b"])
    return c


def test_lm_loss_and_gradient_match_the_port():
    from bench.drivers.train import load_weights as load, port_config
    from repro_torch.models import model as M
    ref = common.reference("h2o-danube-1.8b")
    c = _small_lm()
    pcfg = port_config(c).replace(dtype="float32")
    g = torch.Generator().manual_seed(5)
    w = plain.make_weights(ref.lm_specs(c), g, "cpu")
    lm = M.LM(pcfg, "cpu")
    load(lm, w)
    toks = torch.randint(0, c["vocab_size"], (2, 96), generator=g)
    labels = torch.roll(toks, -1, 1)
    for p in lm.parameters():
        p.requires_grad_(True)
    got, _ = M.loss_fn(lm, pcfg, {"tokens": toks, "labels": labels})
    got.backward()
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want = ref.loss(wr, c, toks, labels, plain.Precision())
    want.backward()
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                             rel=1e-5)
    for n, p in lm.named_parameters():
        rel = (p.grad - wr[n].grad).norm() / wr[n].grad.norm().clamp_min(
            1e-12)
        assert rel < 1e-4, n


def test_adamw_matches_the_port():
    from repro_torch.training import optimizer as O
    ref = common.reference("h2o-danube-1.8b")
    o = {k: v for k, v in common.config(common.manifest(),
                                        "h2o-danube-1.8b")["optimizer"]
         .items() if k != "name"}
    g = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(5, 3, generator=g),
              "b": torch.randn(7, generator=g)}
    mine = {k: v.clone() for k, v in params.items()}
    state = O.init({k: v.clone() for k, v in params.items()})
    theirs = {k: v.clone() for k, v in params.items()}
    adam = ref.AdamW(mine, o)
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in
                 params.items()}
        O.update(O.OptConfig(**o), grads, state, theirs)
        adam.step(mine, grads)
        for k in params:
            assert torch.allclose(mine[k], state["master"][k], atol=1e-7)
