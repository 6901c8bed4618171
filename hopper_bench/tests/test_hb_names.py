"""Every name in BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract."""

import ast
import json
import re

from hopper_bench.tests.tiny import ROOT

from hopper_bench.harness import drivers, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return spec.load_benchmark()


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "hopper_bench/run.py"]
    assert b["paths"] == ["hopper_bench"]
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_name_resolves_to_its_files():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = spec.Cell(b, w["name"])
        assert w["chips"] == 1
        module = drivers.load(cell.traffic["kind"])
        assert callable(module.Driver) and module.FAULTS
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        moved = {m["moves"] for m in cell.per_layer}
        assert moved <= {m["name"] for m in cell.end_to_end}
    for m in b["per_layer"]:
        assert callable(spec.load_reader(m["name"]))


def test_names_units_and_bounds():
    b = bench()
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"])
    texts = [x[k] for key in ("configs", "workloads") for x in b[key] for k in ("why", "source")
             if k in x] + [m["layer"] for m in b["per_layer"]] + b["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len(json.dumps(b, indent=2)) <= 64 * 1024
    workloads = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", [])) <= workloads


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (ROOT / "hopper_bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]] if node.level == 0 else []
            else:
                continue
            assert not set(tops) & {"os2d_torch", "os2d_tpu", "jax", "jaxlib", "flax"}, path


def test_a_traffic_kind_without_a_driver_file_is_refused():
    import pytest

    for kind in ("no_such_kind", "../run"):
        with pytest.raises(ValueError):
            drivers.load(kind)


def test_the_model_takes_every_field_of_the_configuration_file():
    from hopper_bench.harness.common import model_config

    for c in bench()["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        got = model_config(config)
        for key in ("backbone_arch", "use_inverse_geom_model", "use_simplified_affine_model",
                    "class_image_size", "compute_dtype", "resample_precision"):
            assert getattr(got, key) == config[key], key
        assert got.normalization_mean == tuple(config["normalization_mean"])
        assert not got.use_group_norm
        assert model_config(dict(config, use_group_norm=True)).use_group_norm


def test_a_field_the_reference_does_not_follow_is_refused():
    import pytest

    from hopper_bench.harness.common import FOLLOWED_FIELDS, model_config

    config = json.loads((ROOT / bench()["configs"][0]["file"]).read_text())
    with pytest.raises(ValueError, match="corr_interior_first"):
        model_config(dict(config, corr_interior_first=False))
    assert "corr_interior_first" not in FOLLOWED_FIELDS
    for key, value in (("compute_dtype", "bfloat16"), ("resample_precision", "int8"),
                       ("merge_branch_parameters", False)):
        with pytest.raises(ValueError, match=key):
            model_config(dict(config, **{key: value}))
