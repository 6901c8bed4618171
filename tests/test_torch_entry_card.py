"""The port's entry surfaces on the card: checkpoints loaded into card
models, the detection service and its batcher at the shipped 1500-px
target, the ImageNet pretrainer at its default arch, the experiment
launchers' twins through `os2d_torch.main` and the release runbook's twin.

Without a card every test here skips. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_entry_card.py -q

Data and checkpoints are written under temporary directories by the
fixtures (tests/torch_card_scenes.py's writers).
"""

import contextlib
import io
import json
import logging
import os
import random
import shlex
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import torch_card_scenes as scenes_mod
from torch_card_scenes import (
    Launches,
    planted_scene,
    png_b64,
    reference_layout,
    responses_agree,
    top_iou,
    twin,
)

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAT_RTOL, HAT_ATOL = 1e-5, 1e-5
SERVE_CLASSES, SERVE_LARGE_CATALOG = 16, 64
SERVE_REQUEST = (1280, 960)  # detect(): resized to 1500x1125, fm 71x94
SERVE_REQUEST_PATCH = 205  # 240 px once resized by 1500/1280
# detect_batch: mixed sizes whose longer side is the canvas's, so each
# planted 240-px patch keeps its size on the 1500x1500 canvas (fm 94x94)
SERVE_BATCH_SIZES = [(1500, 1125), (1125, 1500), (1500, 1000), (1500, 1500),
                     (1500, 844), (1000, 1500), (1500, 1200), (1200, 1500)]
SERVE_BATCHER_ATOL = 1e-5
PRETRAIN_ARCH, PRETRAIN_SIZE, PRETRAIN_BATCH = "resnet101", 224, 64  # a cut of its 256
PRETRAIN_TRAIN_EPOCHS = 2
PRETRAIN_LOSS_RTOL, PRETRAIN_TOP1_ATOL = 2e-2, 4 / 64
PRETRAIN_C4_RTOL_TO_MAX = 1e-4
EXPERIMENT_TRAIN_STEPS = 3  # the training job's cut: train.optim.max_iter
EXPERIMENT_MIN_MAP = 0.9


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


# ---- checkpoints and the service ----

@pytest.fixture(scope="module")
def request_scene(card):
    """The 64 catalog patches, a planted 1280x960 request scene (its patch
    on the anchor grid once the service resizes it to 1500 px), its box and
    the request payload with the 16-class catalog."""
    from os2d_torch.api import service as service_mod

    rng = np.random.RandomState(20)
    patches = scenes_mod.serve_patches(SERVE_LARGE_CATALOG, seed=20)
    catalog = [Image.fromarray(p) for p in patches[:SERVE_CLASSES]]
    w, h = SERVE_REQUEST
    small = np.asarray(Image.fromarray(patches[0]).resize(
        (SERVE_REQUEST_PATCH, SERVE_REQUEST_PATCH), Image.NEAREST))
    scene, box = planted_scene(w, h, small, rng, service_mod.TARGET_IMAGE_SIZE / max(w, h))
    payload = {"image": {"content": png_b64(scene)},
               "query": [{"content": png_b64(q)} for q in catalog]}
    return {"patches": patches, "catalog": catalog, "scene": scene, "box": box,
            "payload": payload, "rng": rng}


@pytest.fixture(scope="module")
def loaded(request_scene, tmp_path_factory):
    """A seeded card model (seed 1) written as a reference-layout .pth (its
    keys renamed to the reference's, num_batches_tracked added) and as the
    port's own utils.logger.checkpoint_model .pth, each loaded through
    models.checkpoint.load_checkpoint_file into a card model of seed 0;
    with the source's state and first response."""
    from os2d_torch.api.service import DetectionService
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models.checkpoint import load_checkpoint_file
    from os2d_torch.utils.logger import checkpoint_model

    root = str(tmp_path_factory.mktemp("checkpoints"))
    source = Os2dModel(Os2dConfig(), seed=1)
    paths = {"reference": os.path.join(root, "reference_layout.pth"),
             "port": checkpoint_model(source, None, root, model_name="port")}
    torch.save({"net": reference_layout(source.state_dict())}, paths["reference"])
    models = {}
    for name, path in paths.items():
        m = Os2dModel(Os2dConfig(), seed=0)
        state, _ = load_checkpoint_file(path, m.config, m)
        m.load_state_dict(state)
        models[name] = m
    return {"models": models, "source_state": source.state_dict(),
            "source_response": DetectionService(source).detect_from_request(
                request_scene["payload"])}


@pytest.mark.parametrize("layout", ["reference", "port"])
def test_checkpoints_load_into_card_models_as_their_source(layout, loaded, request_scene):
    """Each file loads to the source's state_dict to the bit and answers the
    first request as the source (scores 1e-4, boxes 1e-2 px)."""
    from os2d_torch.api.service import DetectionService

    m = loaded["models"][layout]
    state, want = m.state_dict(), loaded["source_state"]
    assert set(state) == set(want)
    assert all(torch.equal(state[k], want[k]) for k in state)
    got = DetectionService(m).detect_from_request(request_scene["payload"])
    assert responses_agree(got, loaded["source_response"], *SERVE_REQUEST)


def test_service_at_the_shipped_target(loaded, request_scene):
    """DetectionService on the model loaded from the reference layout, at the
    1500-px target and the default tier, a 16-class catalog:
    - a planted 1280x960 PNG/base64 request: its top box on the patch, one
      hat launch, the same response on the CPU (scores 1e-4, boxes 1e-2 px);
    - detect_batch of 8 planted scenes of mixed sizes on the 1500x1500
      canvas: every top box on its patch, one hat launch;
    - a DynamicBatcher(max_batch=8) with 8 client threads: each result
      within scores 1e-5 of detect_batch's, one hat launch per batch formed;
    - a 64-class catalog through the prescreen: one prescreened dispatch,
      the hat kernel once per padded survivor chunk, the response of the
      full path;
    - one "highest" request: the gather once;
    - the hat kernel on the tensors the service passed it (B=1 71x94, B=8
      94x94) at rtol 1e-5, atol 1e-5 of its plain version."""
    from os2d_torch.api.service import DetectionService, DynamicBatcher
    from os2d_torch.models import Os2dConfig
    from os2d_torch.ops import resample_grad
    from os2d_torch.ops.sampling import hat_resample_reference

    model = loaded["models"]["reference"]
    service = DetectionService(model)
    s = request_scene
    w, h = SERVE_REQUEST
    captured = []
    original = resample_grad.FORWARD["default"]

    def capture(corr, px, py, mask_t):
        out = original(corr, px, py, mask_t)
        captured.append((corr, px, py, mask_t, out))
        return out

    batch = [planted_scene(bw, bh, s["patches"][0], s["rng"]) for bw, bh in SERVE_BATCH_SIZES]
    images = [img for img, _ in batch]
    resample_grad.FORWARD["default"] = capture
    try:
        with Launches() as launched:
            resp = service.detect_from_request(s["payload"])
        assert launched["hat"] == 1
        with Launches() as launched:
            batch_resp = service.detect_batch(images, s["catalog"])
        assert launched["hat"] == 1
    finally:
        resample_grad.FORWARD["default"] = original
    assert top_iou(resp, w, h, s["box"]) > 0.5
    cpu_resp = DetectionService(twin(model)).detect_from_request(s["payload"])
    assert responses_agree(resp, cpu_resp, w, h)
    for r, (img, box) in zip(batch_resp, batch):
        assert top_iou(r, img.size[0], img.size[1], box) > 0.5
    assert len(captured) == 2
    for corr, px, py, mask_t, out in captured:
        torch.testing.assert_close(out, hat_resample_reference(corr, px, py, mask_t),
                                   rtol=HAT_RTOL, atol=HAT_ATOL)
    del captured

    sizes_formed = []
    detect_batch = service.detect_batch

    def recorded(imgs, queries):
        sizes_formed.append(len(imgs))
        return detect_batch(imgs, queries)

    service.detect_batch = recorded
    batcher = DynamicBatcher(service, max_batch=len(images), max_wait_ms=50)
    results = [None] * len(images)
    try:
        def client(i):
            results[i] = batcher.detect(images[i], s["catalog"])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(images))]
        with Launches() as launched:
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
    finally:
        batcher.close()
        service.detect_batch = detect_batch
    assert not any(t.is_alive() for t in threads) and None not in results
    assert launched["hat"] == len(sizes_formed)
    for r, want, img in zip(results, batch_resp, images):
        assert responses_agree(r, want, img.size[0], img.size[1], SERVE_BATCHER_ATOL)

    large = [Image.fromarray(p) for p in s["patches"]]
    with Launches() as launched:
        pre_resp = service.detect(s["scene"], large)
    assert service.stats["prescreen_dispatches"] == 1, service.stats
    chunk = int(service.eval_cfg.tpu.eval_class_chunk)
    kept = SERVE_LARGE_CATALOG - service.evaluator.prescreen_pruned
    n_chunks = min(1 << (max(1, -(-kept // chunk)) - 1).bit_length(),
                   -(-SERVE_LARGE_CATALOG // chunk)) if kept else 0
    assert launched["hat"] == n_chunks
    full = DetectionService(model, prescreen_min_classes=10**9).detect(s["scene"], large)
    assert responses_agree(pre_resp, full, w, h)

    highest = twin(model, Os2dConfig(resample_precision="highest"), "cuda")
    with Launches() as launched:
        DetectionService(highest).detect(s["scene"], s["catalog"])
    assert launched["gather"] == 1


# ---- the ImageNet pretrainer ----

def test_pretrainer_at_its_default_arch_matches_the_cpu(card, tmp_path):
    """The pretrainer (os2d_torch/pretrain) at its default arch, crop and
    dtype (ResNet101, 224 px, bf16) at batch 64 on a synthetic ImageFolder
    (the last class excluded): the first step's loss within rtol 2e-2 and
    top-1 within 4/64 of the CPU's from the same weights; its export loaded
    through models.checkpoint.load_checkpoint_file into a ResNet101
    Os2dModel, whose C4 features equal the classifier's trunk within 1e-4
    of their largest magnitude; train() as a user calls it, two epochs,
    leaves finite weights. cuDNN and cuBLAS only: no hand kernel runs."""
    import pickle

    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models.checkpoint import load_checkpoint_file
    from os2d_torch.pretrain import train_imagenet as pretrain

    root = str(tmp_path)
    exclude = scenes_mod.write_image_folder(os.path.join(root, "train"))
    with open(exclude) as f:
        excluded = {line.strip() for line in f if line.strip()}
    dataset = pretrain.ImageFolderDataset(os.path.join(root, "train"), excluded)
    steps_per_epoch = len(dataset) // PRETRAIN_BATCH
    images, labels = next(pretrain.batch_iterator(dataset, PRETRAIN_BATCH, PRETRAIN_SIZE, seed=0,
                                                  rng=random.Random(1)))
    images, labels = torch.from_numpy(images), torch.from_numpy(labels)

    def trainer(device, state=None):
        m = pretrain.init_classifier(PRETRAIN_ARCH, dataset.num_classes, device, seed=0)
        if state is not None:
            m.load_state_dict(state)
        chain = pretrain.ChainSGD(m.parameters(), pretrain.piecewise_constant_schedule(
            0.1, {steps_per_epoch * 30: 0.1, steps_per_epoch * 60: 0.1}))
        return m, pretrain.make_train_step(m, chain)  # bf16, the trainer's default

    card_model, card_step = trainer("cuda")
    start = {k: v.detach().cpu().clone() for k, v in card_model.state_dict().items()}
    got = {k: float(v) for k, v in card_step(images.cuda(), labels.cuda()).items()}
    want = {k: float(v) for k, v in trainer("cpu", start)[1](images, labels).items()}
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - want["loss"]) / want["loss"] <= PRETRAIN_LOSS_RTOL, (got, want)
    assert abs(got["top1"] - want["top1"]) <= PRETRAIN_TOP1_ATOL, (got, want)

    export_path = os.path.join(root, "backbone_torchvision.pkl")
    with open(export_path, "wb") as f:
        pickle.dump(pretrain.export_torchvision_state_dict(card_model), f)
    config = Os2dConfig(backbone_arch=PRETRAIN_ARCH)
    detector = Os2dModel(config)
    state, _ = load_checkpoint_file(export_path, config, detector)
    detector.load_state_dict(state)
    x = torch.randn(1, 320, 320, 3, generator=torch.Generator().manual_seed(2)).cuda()
    with torch.no_grad():
        c4 = detector.extract_features(x)
        trunk = card_model.stem(x.permute(0, 3, 1, 2))
        for block in card_model.blocks():
            trunk = block(trunk)
        trunk = trunk.permute(0, 2, 3, 1)
    assert float((c4 - trunk).abs().max()) <= PRETRAIN_C4_RTOL_TO_MAX * float(trunk.abs().max())
    del detector, card_model, card_step

    trained = pretrain.train(os.path.join(root, "train"), exclude, PRETRAIN_ARCH, PRETRAIN_BATCH,
                             PRETRAIN_TRAIN_EPOCHS, output_path=None,
                             log_every=PRETRAIN_TRAIN_EPOCHS * steps_per_epoch, device="cuda")
    assert all(bool(torch.isfinite(p).all()) for p in trained.parameters())


# ---- the experiment launchers' twins and the release runbook's ----

def _load_script(relative_path):
    """A script of this checkout (experiments/, tools/) as a module."""
    import importlib.util

    path = os.path.join(ROOT, relative_path)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _job_argv(queue_job, **overrides):
    """The argv of `python -m os2d_torch.main` in a job of a launcher twin's
    queue, with `overrides` (dotted keys) appended."""
    _, _, commands, _ = queue_job
    tokens = shlex.split(commands[0])
    assert tokens[:3] == ["python", "-m", "os2d_torch.main"], tokens[:3]
    for k, v in overrides.items():
        tokens[3:] += [k, str(v)]
    return tokens[3:]


@pytest.fixture(scope="module")
def grozi(card, tmp_path_factory):
    """A planted tree in the GroZi layout (as main's DATA_PATH), a
    reference-layout .pth of Os2dModel(Os2dConfig(), seed=1)'s weights and a
    backbone-only .pth of its torchvision-named backbone; DATA_PATH and
    OS2D_DEVICE set for the module."""
    from os2d_torch.models import Os2dConfig, Os2dModel

    work = str(tmp_path_factory.mktemp("grozi"))
    data_path = os.path.join(work, "data")
    scenes_mod.write_grozi_planted_tree(data_path)
    source = Os2dModel(Os2dConfig(), seed=1)
    ref_path = os.path.join(work, "os2d_v2-train.pth")
    torch.save({"net": reference_layout(source.state_dict())}, ref_path)
    backbone_path = os.path.join(work, "backbone.pth")
    torch.save({k: v.detach().cpu() for k, v in source.backbone.state_dict().items()},
               backbone_path)
    saved = {k: os.environ.get(k) for k in ("DATA_PATH", "OS2D_DEVICE")}
    os.environ["DATA_PATH"], os.environ["OS2D_DEVICE"] = data_path, "cuda"
    yield {"work": work, "data_path": data_path, "ref_path": ref_path,
           "backbone_path": backbone_path}
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_experiment_launcher_jobs_run_through_main(grozi):
    """The first job of experiments/launcher_grozi_eval_torch.py --no-launch
    (grozi-val-new-cl at 1280 px, the default 7-level pyramid, full width)
    with init.model the reference-layout .pth, through
    os2d_torch.main.main(argv) with its log written as the launcher's job
    script tees it: mAP@0.50 >= 0.9 on the planted patches, read back from
    the log by experiments/launcher_eval_collect_torch.py, and a hat launch
    at least once a level; then the first job of
    experiments/launcher_exp1_torch.py (lossCL, the simplified affine
    model) from the backbone-only .pth, cut to EXPERIMENT_TRAIN_STEPS
    iterations: finite losses, one backward launch a step."""
    from os2d_torch import main as port_main
    from os2d_torch.engine import train as train_module
    from os2d_torch.utils import launcher

    work = grozi["work"]
    grozi_eval = _load_script("experiments/launcher_grozi_eval_torch.py")
    eval_job = grozi_eval.build_jobs(
        grozi_eval.create_args_parser().parse_args(["--no-launch"])).jobs[0]
    dataset = "grozi-val-new-cl"
    eval_root = os.path.join(work, "output", "eval")
    log_dir = os.path.join(eval_root, dataset)
    os.makedirs(log_dir)
    eval_argv = _job_argv(eval_job, **{"init.model": grozi["ref_path"], "output.path": log_dir})
    handler = logging.FileHandler(os.path.join(log_dir, f"{eval_job[3]}out.txt"))
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
    os2d_logger = logging.getLogger("OS2D")
    os2d_logger.addHandler(handler)
    try:
        with Launches() as launched:
            _, meters = port_main.main(eval_argv)
    finally:
        os2d_logger.removeHandler(handler)
        handler.close()
    eval_map = float(meters[dataset]["mAP@0.50"])
    assert eval_map >= EXPERIMENT_MIN_MAP
    collected = _load_script("experiments/launcher_eval_collect_torch.py").collect(
        eval_root, "mAP@0.50")
    assert [(d, v) for d, _, v in collected] == [(dataset, float(f"{eval_map:.4f}"))]
    levels = len(port_main.parse_opts(eval_argv)[0].eval.scales_of_image_pyramid)
    assert launched["hat"] >= levels

    exp1 = _load_script("experiments/launcher_exp1_torch.py")
    train_job = exp1.build_jobs(launcher.create_args_parser().parse_args(["--no-launch"])).jobs[0]
    train_argv = _job_argv(train_job, **{
        "init.model": grozi["backbone_path"], "output.path": os.path.join(work, "exp1"),
        "train.optim.max_iter": EXPERIMENT_TRAIN_STEPS})
    steps = []
    original = train_module.train_one_batch

    def recorded(*args, **kwargs):
        meters = original(*args, **kwargs)
        steps.append([float(meters[k]) for k in ("loss", "grad_norm")])
        return meters

    train_module.train_one_batch = recorded
    try:
        with Launches() as launched:
            port_main.main(train_argv)
    finally:
        train_module.train_one_batch = original
    assert len(steps) == EXPERIMENT_TRAIN_STEPS and np.isfinite(steps).all(), steps
    assert launched["backward"] == EXPERIMENT_TRAIN_STEPS


@pytest.mark.parametrize("tol,code,verdict", [("100", 0, "PASS"), ("0", 1, "FAIL")])
def test_release_runbook_gates_at_the_published_protocol(tol, code, verdict, grozi):
    """tools/parity_release_torch.py on the card at the published protocol
    (SCALE 1280, the default pyramid) with the reference-layout .pth and the
    planted tree: --tol 100 prints "parity_gate": "PASS" and exits 0, --tol
    0 "FAIL" and exits 1; the hat kernel launched."""
    runbook = _load_script("tools/parity_release_torch.py")
    out = io.StringIO()
    with Launches() as launched, contextlib.redirect_stdout(out):
        try:
            runbook.main(["--row", "v2-train", "--checkpoint", grozi["ref_path"],
                          "--data-path", grozi["data_path"], "--tol", tol, "--device", "cuda"])
            exit_code = 0
        except SystemExit as e:
            exit_code = e.code
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    assert exit_code == code, (exit_code, lines)
    assert lines and lines[-1].get("parity_gate") == verdict, lines
    assert launched["hat"] > 0
