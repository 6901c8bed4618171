"""The port's ImageNet pretrainer (os2d_torch/pretrain/train_imagenet.py) and
full ResNet classifier (models/resnet.py: ResNetClassifier) against the JAX
package's, at tests/test_pretrain.py's size: ResNet50 at 64x64, batches of
4, 3 classes, on seeded numpy inputs, the JAX weights converted by
`models.from_jax.classifier_state_dict_from_jax`.

How close fp32 can be held: at this size the classifier's fp32 results carry
rounding noise far above fp32's epsilon (BatchNorm over 16 values per channel
in layer4, 50 layers of random He weights). JAX against itself shows it: its
jitted first step and the same step run op by op differ by 1.8% in the
update's norm and by 26% in the worst tensor's update, and their second-step
losses by 5% (on an x86 CPU, XLA's jit against op by op). So the algorithm is held
where rounding cannot hide a difference: both packages in fp64, with the
JAX modules' fp32 casts (BatchNorm, the log-softmax) widened to fp64 in this
process by replacing their `jnp` with a shim whose float32 is float64 (the
package's files are untouched). There, the forward, both steps and every
leaf, BatchNorm's decayed running statistics included, agree within 1e-7 of
each tensor's largest magnitude. In fp32 the port is held to JAX within
three times JAX's own distance from that fp64 run (the forward), and within
the jit-versus-op-by-op spread above for the first step (loss rtol 1e-4,
update norm 5%, running statistics rtol 1e-4); the bf16 step's loss within
three times JAX's own distance between its bf16 and fp32 losses (2e-2
relative cannot hold: JAX's bf16 first loss is 13.5% from its fp32 one).

Also: the ImageFolder's RepMet exclusion and the crop draws equal JAX's for
the same seed; the optimizer equals the optax chain on random tensors
across both schedule boundaries; the export loads through
`load_checkpoint_file` into an `Os2dModel` backbone whose C4 features equal
JAX's `import_torch_resnet_state_dict` -> `resnet_c4_forward` (the JAX
export too); two gloo ranks (tests/torch_dist_worker.py) take the steps of
one process over the whole batch, in fp64 within 1e-9, with BatchNorm's
statistics over the global batch, and train() over the ranks leaves equal
weights on both and writes only rank 0's export.
"""

import os
import pickle
import random

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_worker as worker
from os2d_tpu.models import resnet as jresnet
from os2d_tpu.pretrain import train_imagenet as jpre
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.checkpoint import load_checkpoint_file
from os2d_torch.models.from_jax import classifier_state_dict_from_jax
from os2d_torch.models.resnet import ResNetClassifier
from os2d_torch.parallel.spawn import run_local_group
from os2d_torch.pretrain import train_imagenet as tpre
from test_pretrain import make_image_folder

ARCH, CLASSES, SIZE, BATCH = "resnet50", 3, 64, 4
# the schedule's lr and scales are exact in binary, so that the port's
# fp32-rounded schedule and JAX's fp64 one (under enable_x64) coincide; both
# boundaries fall inside the tests' steps
LR, BOUNDARIES = 0.125, {1: 0.5, 2: 0.5}
FP64_RTOL = 1e-7
FORWARD_NOISE_FACTOR = 3.0
STEP_LOSS_RTOL, STEP_UPDATE_NORM_RTOL, STATS_RTOL = 1e-4, 5e-2, 1e-4
# a bf16 step's loss carries decorrelated bf16 rounding noise: it is held
# within 3x JAX's own |bf16 - fp32| (the card tests' BF16_STEP_RULE); here
# JAX's bf16 first loss is 13.5% from its fp32 one and the port's 14.5% from
# JAX's bf16 one
BF16_STEP_RULE = 3.0
EXPORT_ATOL = 1e-4
MESH_RTOL = 1e-9
GROUP_TIMEOUT_S = 300


class _Fp64Numpy:
    """jax.numpy with float32 standing for float64: the JAX modules' fp32
    casts widen, so that a run under jax.enable_x64 is fp64 throughout."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def jax_chain():
    schedule = optax.piecewise_constant_schedule(LR, BOUNDARIES)
    return optax.chain(optax.add_decayed_weights(1e-4), optax.trace(decay=0.9),
                       optax.scale_by_schedule(lambda count: -schedule(count)))


def port_model(params, dtype=torch.float32):
    model = ResNetClassifier(ARCH, CLASSES, device="cpu")
    model.load_state_dict(classifier_state_dict_from_jax(params))
    return model.to(dtype)


def port_steps(params, batches, dtype):
    model = port_model(params, torch.float64 if dtype == torch.float64 else torch.float32)
    optimizer = tpre.ChainSGD(model.parameters(),
                              tpre.piecewise_constant_schedule(LR, BOUNDARIES))
    step = tpre.make_train_step(model, optimizer, dtype)
    losses = [float(step(torch.from_numpy(im), torch.from_numpy(lb))["loss"])
              for im, lb in batches]
    return losses, tpre.export_torchvision_state_dict(model)


def jax_steps(params, batches, dtype):
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    optimizer = jax_chain()
    state = optimizer.init(p)
    step = jpre.make_train_step(optimizer, CLASSES, compute_dtype=dtype)
    losses = []
    for im, lb in batches:
        p, state, m = step(p, state, jnp.asarray(im, dtype), jnp.asarray(lb))
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, jpre.export_torchvision_state_dict(p))


@pytest.fixture(scope="module", autouse=True)
def _two_intra_op_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    init = jax.jit(jresnet.init_resnet_classifier_params, static_argnums=(1, 2))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), ARCH, CLASSES))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.RandomState(0)
    return [(rng.randn(BATCH, SIZE, SIZE, 3), rng.randint(0, CLASSES, BATCH).astype(np.int32))
            for _ in range(2)]


@pytest.fixture(scope="module")
def jax_fp64(params, batches):
    """JAX's forward and two steps in fp64 (its fp32 casts widened)."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jresnet, "jnp", _Fp64Numpy())
        mp.setattr(jpre, "jnp", _Fp64Numpy())
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        logits, new = jax.jit(lambda p, x: jresnet.resnet_classifier_forward(
            p, x, jnp.float64, train_bn=True))(p64, jnp.asarray(batches[0][0]))
        forward = (np.asarray(logits), jax.tree_util.tree_map(np.asarray, new))
        return {"forward": forward, "steps": jax_steps(params, batches, jnp.float64)}


@pytest.fixture(scope="module")
def jax_fp32(params, batches):
    """JAX's first fp32 step: (losses, export)."""
    return jax_steps(params, batches[:1], jnp.float32)


def _leaves_close(got, want, rtol):
    """Each tensor within rtol of its largest magnitude."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(np.asarray(got[k], np.float64) - w).max()
        assert err <= rtol * max(np.abs(w).max(), 1e-30), (k, err, np.abs(w).max())


def _running_stats(tree):
    """{bn module name: (mean, var)} of a JAX classifier tree."""
    out = {"bn1": (tree["bn1"]["mean"], tree["bn1"]["var"])}
    for layer in ("layer1", "layer2", "layer3", "layer4"):
        for i, block in enumerate(tree[layer]):
            for name in ("bn1", "bn2", "bn3", "downsample_bn"):
                if name in block:
                    key = f"{layer}.{i}.{'downsample.1' if name == 'downsample_bn' else name}"
                    out[key] = (block[name]["mean"], block[name]["var"])
    return out


def test_image_folder_excludes_classes_like_jax(tmp_path):
    exclude_file = make_image_folder(str(tmp_path))
    with open(exclude_file) as f:
        excluded = {line.strip() for line in f}
    got = tpre.ImageFolderDataset(str(tmp_path), excluded)
    want = jpre.ImageFolderDataset(str(tmp_path), excluded)
    assert got.num_classes == want.num_classes == 3
    assert got.samples == want.samples and len(got) == 12
    assert got.class_to_idx == want.class_to_idx


def test_crop_draws_match_jax(tmp_path):
    """Seeded alike, the two iterators give the same batches: the order from
    random.Random(seed), the crops and flips from the module-level random
    (JAX's) or from an explicit generator seeded as that stream."""
    make_image_folder(str(tmp_path))
    dataset = jpre.ImageFolderDataset(str(tmp_path))
    random.seed(5)
    want = [next(it) for it in [jpre.batch_iterator(dataset, 4, 48, seed=2)] for _ in range(5)]
    random.seed(5)
    got = [next(it) for it in [tpre.batch_iterator(dataset, 4, 48, seed=2)] for _ in range(5)]
    explicit = [next(it) for it in [tpre.batch_iterator(dataset, 4, 48, seed=2,
                                                        rng=random.Random(5))] for _ in range(5)]
    for (wi, wl), (gi, gl), (ei, el) in zip(want, got, explicit):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(ei, wi)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(el, wl)


def test_optimizer_matches_optax_chain():
    """ChainSGD against optax's chain on random tensors over four steps
    (both schedule boundaries), a base standing in for two of them as the
    post-EMA statistics do: within fp32 rounding."""
    rng = np.random.RandomState(1)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    optimizer = jax_chain()
    jp = [jnp.asarray(p) for p in params]
    state = optimizer.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    chain = tpre.ChainSGD(tp, tpre.piecewise_constant_schedule(LR, BOUNDARIES))
    for _ in range(4):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        base = rng.randn(*shapes[1]).astype(np.float32)
        jgrads = [jnp.asarray(grads[0]), jnp.zeros(shapes[1], jnp.float32), jnp.asarray(grads[2])]
        updates, state = optimizer.update(jgrads, state, jp)
        jp = optax.apply_updates([jp[0], jnp.asarray(base), jp[2]], updates)
        tp[0].grad, tp[1].grad, tp[2].grad = torch.from_numpy(grads[0]), None, torch.from_numpy(
            grads[2])
        chain.step({id(tp[1]): torch.from_numpy(base)})
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    assert chain.count == 4


def test_classifier_forward_matches_jax(params, batches, jax_fp64):
    """The train-mode forward (logits and new running statistics): fp64
    within 1e-7 of each tensor's magnitude; fp32 within three times the
    distance of JAX's own fp32 forward from the fp64 one; eval mode (running
    statistics) likewise in fp64."""
    x = batches[0][0]
    want64, want64_stats = jax_fp64["forward"]
    model64 = port_model(params, torch.float64)
    logits64, stats64 = model64(torch.from_numpy(x), train_bn=True, compute_dtype=torch.float64)
    _leaves_close({"logits": logits64.detach().numpy()}, {"logits": want64}, FP64_RTOL)
    got_stats = {k: np.stack([m.numpy(), v.numpy()]) for k, (m, v) in stats64.items()}
    want_stats = {k: np.stack(mv) for k, mv in _running_stats(want64_stats).items()}
    _leaves_close(got_stats, want_stats, FP64_RTOL)

    jf = jax.jit(lambda p, xx: jresnet.resnet_classifier_forward(p, xx, train_bn=True))
    logits32_j, new32_j = jf(params, jnp.asarray(x, jnp.float32))
    logits32, stats32 = port_model(params)(torch.from_numpy(x).float(), train_bn=True)
    noise = np.abs(np.asarray(logits32_j) - want64).max()
    err = np.abs(logits32.detach().numpy() - np.asarray(logits32_j)).max()
    assert err <= FORWARD_NOISE_FACTOR * noise, (err, noise)
    for k, (m, v) in _running_stats(jax.tree_util.tree_map(np.asarray, new32_j)).items():
        for got, want, want64_k in ((stats32[k][0], m, want_stats[k][0]),
                                    (stats32[k][1], v, want_stats[k][1])):
            noise = np.abs(want - want64_k).max()
            err = np.abs(got.numpy() - want).max()
            assert err <= FORWARD_NOISE_FACTOR * noise + 1e-7 * np.abs(want).max(), (k, err, noise)

    # eval mode: the running statistics, no new ones
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jresnet, "jnp", _Fp64Numpy())
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        want_eval = jax.jit(lambda p, xx: jresnet.resnet_classifier_forward(
            p, xx, jnp.float64)[0])(p64, jnp.asarray(x))
    got_eval, none = model64(torch.from_numpy(x), compute_dtype=torch.float64)
    assert none == {}
    _leaves_close({"logits": got_eval.detach().numpy()}, {"logits": np.asarray(want_eval)},
                  FP64_RTOL)


def test_two_steps_match_jax_fp64(params, batches, jax_fp64):
    """Two make_train_step steps across the schedule's boundaries, fp64 on
    both sides: both losses and every leaf of the
    result, BatchNorm's running mean and var (their EMA update plus weight
    decay and momentum) included."""
    want_losses, want = jax_fp64["steps"]
    got_losses, got = port_steps(params, batches, torch.float64)
    np.testing.assert_allclose(got_losses, want_losses, rtol=FP64_RTOL)
    _leaves_close(got, want, FP64_RTOL)


def test_first_step_fp32_and_bf16_match_jax(params, batches, jax_fp32):
    """The first fp32 step: the loss within rtol 1e-4, the update within 5%
    of JAX's in norm over all weights (JAX's own jit and op-by-op steps are
    1.8% apart), each running statistic within rtol 1e-4 of its largest
    magnitude. The first bf16 step (the default compute dtype): the loss
    within three times JAX's own |bf16 - fp32| of JAX's bf16 loss."""
    one = batches[:1]
    want_losses, want = jax_fp32
    got_losses, got = port_steps(params, one, torch.float32)
    np.testing.assert_allclose(got_losses, want_losses, rtol=STEP_LOSS_RTOL)
    start = {k: v.numpy() for k, v in classifier_state_dict_from_jax(params).items()}
    weights = [k for k in want if "running" not in k]
    num = sum(np.square(got[k].astype(np.float64) - want[k]).sum() for k in weights)
    den = sum(np.square(want[k].astype(np.float64) - start[k]).sum() for k in weights)
    assert np.sqrt(num / den) <= STEP_UPDATE_NORM_RTOL, np.sqrt(num / den)
    _leaves_close({k: got[k] for k in want if "running" in k},
                  {k: want[k] for k in want if "running" in k}, STATS_RTOL)

    want_bf16, _ = jax_steps(params, one, jnp.bfloat16)
    got_bf16, _ = port_steps(params, one, torch.bfloat16)
    bf16_noise = abs(want_bf16[0] - want_losses[0])
    assert abs(got_bf16[0] - want_bf16[0]) <= BF16_STEP_RULE * bf16_noise, (
        got_bf16, want_bf16, want_losses)


def _c4_features(model_sd_or_tree, x, jax_side):
    if jax_side:
        c4 = jresnet.import_torch_resnet_state_dict(model_sd_or_tree, ARCH)
        return np.asarray(jresnet.resnet_c4_forward(c4, jnp.asarray(x)))
    return model_sd_or_tree.extract_features(torch.from_numpy(x)).detach().numpy()


def test_export_initializes_the_detector_backbone(params, batches, jax_fp32, tmp_path):
    """A trained classifier's export (the port's and JAX's
    backbone_torchvision.pkl) through `load_checkpoint_file`: the backbone's
    tensors are the file's, and an Os2dModel loaded from the port's export
    gives C4 features equal to JAX's import of the same file (within 1e-4
    of their largest magnitude: eval-mode BatchNorm with barely trained
    statistics lets the activations grow to ~1e6) and to the classifier's
    own trunk."""
    _, export = port_steps(params, batches[:1], torch.float32)
    _, jax_export = jax_fp32
    x = np.random.RandomState(3).randn(1, SIZE, SIZE, 3).astype(np.float32)
    features = {}
    for name, sd in (("port", export), ("jax", jax_export)):
        path = tmp_path / f"{name}_backbone_torchvision.pkl"
        with open(path, "wb") as f:
            pickle.dump(sd, f)
        state, optimizer_state = load_checkpoint_file(str(path), Os2dConfig())
        assert optimizer_state is None
        for k, v in state.items():
            if k.startswith("backbone."):
                np.testing.assert_array_equal(v.numpy(), sd[k[len("backbone."):]], err_msg=k)
        if name == "port":
            model = Os2dModel(Os2dConfig(), device="cpu", seed=1)
            model.load_state_dict(state)
            got = features[name] = _c4_features(model, x, False)
            want = _c4_features(sd, x, True)
            np.testing.assert_allclose(got, want, rtol=0, atol=EXPORT_ATOL * max(1.0, np.abs(
                want).max()))
    trunk = port_model(params)
    trunk.load_state_dict({k: torch.from_numpy(v) for k, v in export.items()})
    # the classifier's own C4 (stem and layer1-3 in eval mode)
    x_t = torch.from_numpy(x)
    own = trunk.stem(x_t.permute(0, 3, 1, 2))
    for block in trunk.blocks():
        own = block(own)
    torch.testing.assert_close(torch.from_numpy(features["port"]),
                               own.permute(0, 2, 3, 1).detach(), rtol=0, atol=0)


def test_two_gloo_ranks_equal_one_process(params, batches, tmp_path):
    """make_train_step over two gloo ranks (2 rows each) from the seed-0
    classifier in fp64 equals one process over the whole batch within 1e-9:
    BatchNorm's statistics are the global batch's (per-rank statistics
    would differ at the first BatchNorm) and the gradients are averaged.
    Then train() over the two ranks: equal weights on both ranks, one
    export, written by rank 0."""
    data = tmp_path / "data"
    exclude = make_image_folder(str(data))
    out = tmp_path / "out"
    inputs = {"seed": 0, "num_classes": CLASSES, "batches": batches, "out_dir": str(tmp_path),
              "train_kwargs": dict(data_root=str(data), repmet_exclude_file=exclude, arch=ARCH,
                                   batch_size=4, epochs=1, steps_per_epoch=2, image_size=SIZE,
                                   output_path=str(out), log_every=1, device="cpu")}
    ranks = run_local_group(worker.pretrain_rank, 2, (inputs,), devices=["cpu", "cpu"],
                            timeout_s=GROUP_TIMEOUT_S)

    model = tpre.init_classifier(ARCH, CLASSES, "cpu", 0).double()
    optimizer = tpre.ChainSGD(model.parameters(), tpre.piecewise_constant_schedule(LR,
                                                                                   BOUNDARIES))
    step = tpre.make_train_step(model, optimizer, torch.float64)
    single = [{k: float(v) for k, v in step(torch.from_numpy(im), torch.from_numpy(lb)).items()}
              for im, lb in batches]
    for rank in ranks:
        for got, want in zip(rank["metrics"], single):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=MESH_RTOL, err_msg=k)
    assert ranks[0]["digest"] == ranks[1]["digest"]
    mesh_state = torch.load(tmp_path / "pretrain_mesh.pth", weights_only=True)
    _leaves_close({k: v.numpy() for k, v in mesh_state.items()},
                  {k: v.numpy() for k, v in model.state_dict().items()}, MESH_RTOL)
    assert ranks[0]["train_digest"] == ranks[1]["train_digest"]
    assert os.listdir(out) == ["backbone_torchvision.pkl"]


def test_main_trains_and_exports_on_the_cpu(tmp_path):
    """`python -m os2d_torch.pretrain.train_imagenet` as one process: an
    epoch of the image folder at the trainer's 224 px, the export written."""
    exclude = make_image_folder(str(tmp_path / "data"))
    out = tmp_path / "out"
    tpre.main([str(tmp_path / "data"), "--repmet-exclude", exclude, "--arch", ARCH,
               "--batch-size", "4", "--epochs", "1", "--output", str(out), "--device", "cpu"])
    with open(out / "backbone_torchvision.pkl", "rb") as f:
        export = pickle.load(f)
    assert export["fc.weight"].shape == (CLASSES, 2048)
    assert np.isfinite(export["layer4.2.bn3.running_var"]).all()
