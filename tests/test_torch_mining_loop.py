"""The port's training loop with hard-patch mining against the JAX
package's, on the CPU: `trainval_loop` for 3 iterations with
cfg.train.mining.do_mining and mine_hard_patches_iter 2 (mining at
iterations 0 and 2, the batches in between replaying the records), the
device class cache "required" on both sides, at the mining recipe of
tests/test_torch_mining.py, from the same weights and seeds: the same mined
records at each mining, and the loss trajectory within
tests/test_torch_train_loop.py's tolerance (rtol 1e-3).
"""

import random

import numpy as np

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.engine import mining as jmining
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.engine.optimization import create_optimizer as jax_create_optimizer
from os2d_tpu.engine.train import build_trainable_mask as jax_trainable_mask
from os2d_tpu.engine.train import trainval_loop as jax_trainval_loop
from os2d_tpu.models import Os2dConfig as JaxOs2dConfig
from os2d_tpu.models import Os2dModel as JaxOs2dModel
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import build_train_dataloader_from_config
from os2d_torch.engine import mining
from os2d_torch.engine import train as ttrain
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import trainable_parameters, trainval_loop
from test_torch_mining import SEED, _port_model, mining_cfg, setup  # noqa: F401 (fixture)

LOOP_RTOL = 1e-3  # tests/test_torch_train_loop.py's


def _loop_cfg(cfg, out_dir):
    cfg = mining_cfg(cfg)
    cfg.train.mining.do_mining = True
    cfg.train.mining.mine_hard_patches_iter = 2
    cfg.train.optim.lr = 1e-3
    cfg.train.optim.max_iter = 3
    cfg.eval.iter = 1  # the log holds every step's loss
    cfg.tpu.device_class_cache = "required"
    cfg.output.path = str(out_dir)
    return cfg


def test_trainval_loop_with_mining_matches_jax(setup, tmp_path, monkeypatch):
    jds, tds, params = setup
    calls = {"jax": [], "torch": []}
    for module, key in ((jmining, "jax"), (mining, "torch")):
        original = module.mine_hard_patches

        def counted(*args, _original=original, _key=key, **kwargs):
            out = _original(*args, **kwargs)
            calls[_key].append(out)
            return out

        monkeypatch.setattr(module, "mine_hard_patches", counted)
    monkeypatch.setattr(ttrain, "mine_hard_patches", mining.mine_hard_patches)

    jcfg = _loop_cfg(jax_default_cfg(), tmp_path / "jax")
    random.seed(SEED)
    jloader, _ = jax_build(jcfg, dataset_train=jds)
    optimizer = jax_create_optimizer(jcfg.train.optim, jax_trainable_mask(params, jcfg.train))
    _, _, want_log, _ = jax_trainval_loop(
        jloader, JaxOs2dModel(JaxOs2dConfig(class_image_size=128, resample_precision="highest")),
        params, jcfg, JaxObjectiveConfig(), optimizer, optimizer.init(params))

    cfg = _loop_cfg(get_default_cfg(), tmp_path / "torch")
    loader, _ = build_train_dataloader_from_config(cfg, tds, seed=SEED)
    model = _port_model(params)
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    got_log, _ = trainval_loop(loader, model, cfg, ObjectiveConfig(), optimizer)
    assert loader.device_class_cache is not None and jloader.device_class_cache is not None

    assert len(calls["torch"]) == len(calls["jax"]) == 2  # iterations 0 and 2
    for g, w in zip(calls["torch"], calls["jax"]):
        assert list(g) == list(w)
        for image_id in w:
            assert ([(r["role"], r["label_global"], r["anchor_index"]) for r in g[image_id]]
                    == [(r["role"], r["label_global"], r["anchor_index"]) for r in w[image_id]])
    assert set(got_log) == set(want_log)
    assert np.isfinite(np.asarray(got_log["train_loss"], np.float64)).sum() == 3
    for key in (k for k in want_log if "time" not in k):
        np.testing.assert_allclose(np.asarray(got_log[key], np.float64),
                                   np.asarray(want_log[key], np.float64), rtol=LOOP_RTOL,
                                   atol=1e-6, err_msg=key)
