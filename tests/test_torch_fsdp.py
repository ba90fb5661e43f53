"""The port's FSDP / ZeRO-3 (``parallel/fsdp.py``) on four spawned gloo ranks
on the CPU, mirroring tests/test_fsdp.py: the placement rule against JAX's
``fsdp_spec`` (no spawn), a tree placed under TP x FSDP on a 2 x 2 mesh,
the trainer's DP x TP x FSDP step against the port's solo step with dropout
on (loss and err rtol 1e-5, parameters atol 3e-5 / rtol 1e-4), the Adam
moments sharded like their parameters, the gathered state round trip, an
FSDP frame model (BatchNorm) through a step, an eval and a checkpoint that
a solo trainer loads, and ``dryrun_multichip`` in the same ranks."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_cases as cases
from audio2face_tpu.parallel.fsdp import MIN_FSDP_ELEMS as JAX_MIN_FSDP_ELEMS
from audio2face_tpu.parallel.fsdp import fsdp_spec as jax_fsdp_spec
from audio2face_tpu_torch.data.synthetic import generate_synthetic_vocaset
from audio2face_tpu_torch.parallel.fsdp import MIN_FSDP_ELEMS, fsdp_spec, state_memory_bytes
from torch_gloo import run_ranks

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


N_VERTS = 523  # the CLI run's head, as tests/test_torch_cli.py's
SUBJECT, SENTENCE = "FaceTalk_170809_00138_TA", "sentence01"  # in the test split


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = root / "audio2mesh.yaml"
    cfg.write_text((REPO / "configs" / "audio2mesh.yaml").read_text().replace("15069", str(3 * N_VERTS)))
    cli = {"root": str(root), "cfg": str(cfg), "subject": SUBJECT, "sentence": SENTENCE,
           "data": generate_synthetic_vocaset(str(root / "vocaset"), n_verts=N_VERTS,
                                              sentences_per_subject=1, seconds_per_sentence=0.6)}
    data = {"log_dir": str(tmp_path_factory.mktemp("logs")), "cli": cli}
    return run_ranks(4, cases.fsdp_cases, (data,), tmp_path_factory.mktemp("gloo"))


@pytest.mark.parametrize("shape, n_data, base, min_elems", [
    ((768, 3072), 8, (), None), ((3072, 768), 8, (), None),
    ((768, 3072), 8, (None, "model"), None), ((768, 3072), 8, ("model", None), None),
    ((128, 15069), 8, (), None), ((768,), 8, (), None), ((48,), 8, ("model",), None),
    ((15069, 3), 8, (), 1), ((768, 3072), 1, (), None), ((3072, 768), 2, ("model",), None),
])
def test_fsdp_spec_rules(shape, n_data, base, min_elems):
    kw = {} if min_elems is None else {"min_elems": min_elems}
    assert MIN_FSDP_ELEMS == JAX_MIN_FSDP_ELEMS
    want = jax_fsdp_spec(shape, n_data, base=P(*base), **kw)
    assert fsdp_spec(shape, n_data, base=base, **kw) == tuple(want) == want


def test_shard_state_fsdp_places_leaves(results):
    """TP keeps its model dimension and FSDP claims another: the torch
    (out, in) weights take JAX's (in, out) specs transposed; small leaves
    keep their base (the column-parallel bias stays model-split, whole over
    data); a large leaf outside the encoder shards on its divisible dim."""
    for got in results:
        placed = got["placements"]
        # intermediate_dense (3072, 768): TP rows -> (1536, 768), FSDP dim 1
        assert placed["audio_encoder.layers.0.intermediate_dense.weight"] == (
            ("Shard(dim=1)",), (1536, 384))
        # out_proj (768, 768): TP columns -> (768, 384), FSDP dim 0
        assert placed["audio_encoder.layers.0.out_proj.weight"] == (("Shard(dim=0)",), (384, 384))
        assert placed["audio_encoder.layers.0.intermediate_dense.bias"] == ("whole", (1536,))
        assert placed["audio_encoder.layers.0.out_proj.bias"] == ("whole", (768,))
        # vertice_map (15069, 128): 15069 is odd, so dim 1
        assert placed["vertice_map.weight"] == (("Shard(dim=1)",), (15069, 64))
        assert placed["audio_encoder.layers.0.layer_norm.weight"] == ("whole", (768,))
        whole, local = got["memory"]
        assert local < whole / 2


def test_trainer_fsdp_step_matches_single_device(results):
    solo = results[0]["fsdp_tp_step"]["solo"]
    for got in results:
        step = got["fsdp_tp_step"]
        assert step["fsdp"] and step["tensor_parallel"]
        for k, v in solo["metrics"].items():
            np.testing.assert_allclose(step["sharded"]["metrics"][k], v, rtol=1e-5, err_msg=k)
        for k, v in solo["params"].items():
            np.testing.assert_allclose(step["sharded"]["params"][k], v, atol=3e-5, rtol=1e-4,
                                       err_msg=k)
    got = results[0]
    # the trainer's encoder lives sharded: TP dim kept, FSDP dim added, and
    # the Adam moments mirror it (the ZeRO-3 point)
    placed = got["fsdp_tp_placements"]
    assert placed["intermediate_dense.weight"] == (("Shard(dim=1)",), (256, 32))
    assert got["moment"] == (("Shard(dim=1)",), (256, 32))


def test_gathered_state_round_trips_and_names_the_solo_keys(results):
    for got in results:
        assert got["roundtrip"] == 0.0 and got["roundtrip_moments"] == 0.0
    assert set(results[0]["state_keys"]) == set(results[0]["fsdp_tp_step"]["solo"]["params"])


def test_trainer_fsdp_frame_model_step_eval_and_checkpoint(results):
    for got in results:
        frame = got["frame"]
        assert frame["fsdp"]
        assert np.isfinite(frame["loss"]) and np.isfinite(frame["err"])
    solo = results[0]["frame"]
    for k, v in solo["state"].items():  # the checkpoint rank 0 wrote, loaded solo
        np.testing.assert_array_equal(solo["solo_loaded"][k], v, err_msg=k)


def test_fit_on_a_mesh_writes_once_and_resumes(results):
    """``fit`` on four ranks: the same result on every rank, one
    ``metrics.jsonl`` and the checkpoints written by rank 0 alone, and a
    fresh sharded experiment resuming from them reaches the third epoch
    (step 6, two steps an epoch) on every rank."""
    fits = [r["fit"] for r in results]
    assert [f["writer"] for f in fits] == [True, False, False, False]
    assert len({f["result"] for f in fits}) == 1 and fits[0]["result"][0] == 2
    assert len({f["resumed"] for f in fits}) == 1 and fits[0]["resumed"][1] == 6
    fit_dir = Path(fits[0]["dir"])
    rows = [json.loads(line) for line in (fit_dir / "metrics.jsonl").read_text().splitlines()]
    epochs = [r["epoch"] for r in rows if "val/err" in r]
    assert epochs[:2] == [0, 1] and epochs[-1] == 2
    assert any(c.startswith("epoch=") for c in os.listdir(fit_dir / "checkpoints"))


def test_cli_train_under_a_four_rank_group(results):
    """``cli.train`` on every rank of a group, as torchrun runs it: data
    parallel over the four ranks, rank 0 alone prints and writes the
    metrics, the checkpoint and the prediction."""
    out = results[0]["cli"]["stdout"]
    assert "Best val/err" in out and "predict metrics:" in out
    assert all(r["cli"]["stdout"] == "" for r in results[1:])
    logs = list(Path(results[0]["cli"]["root"]).glob("logs/*"))
    assert len(logs) == 1
    rows = [json.loads(line) for line in (logs[0] / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows if "val/err" in r] == [0]
    assert os.listdir(logs[0] / "checkpoints")
    pred = np.load(logs[0] / "pred_verts.npy")
    assert pred.shape[1:] == (N_VERTS, 3) and np.isfinite(pred).all()


def test_dryrun_multichip_in_four_ranks(results):
    summary = results[0]["dryrun"]
    assert summary["mesh"] == {"data": 2, "model": 2}
    assert summary["fsdp"] and summary["tensor_parallel"]
    assert summary["sp_hidden"] == (2, 12, 64) and summary["pp_hidden"] == (4, 12, 64)
    assert np.isfinite(summary["loss"]) and summary["step_collectives"] > 0


def test_state_memory_bytes_counts_local_parts():
    m = torch.nn.Linear(4, 3)
    assert state_memory_bytes(m) == (12 + 3) * 4
    assert state_memory_bytes({"a": torch.zeros(2, dtype=torch.bfloat16), "b": [torch.zeros(3)]}) == 16
