"""The port's Orbax directory checkpoints against the JAX package's, on
the CPU: the zstd decoder (`native/zstd.cpp`) against `zstandard`, the
OCDBT and zarr layer (`training/orbax_dir.py`) against `tensorstore`,
directories written by either package restored by the other, the
staging and refusals of `ggnn_tpu/training/checkpoint.py`, mid-epoch
resume from a directory, serving and a mesh save. `zstandard`,
`tensorstore` and orbax are the oracles here; the port imports none.

Tolerances, each with its reason:
  * checkpoints, both ways: bit-equal (a checkpoint moves bits, not
    arithmetic);
  * a run resumed from a directory against the uninterrupted port run:
    rtol 1e-5 / atol 1e-6 (tests/test_torch_training_extras.py; on the
    CPU the two are bit-equal), against JAX's uninterrupted run: rtol
    5e-4 / atol 5e-5 (two epochs of f32 training in another summation
    order, the Runner tolerance of tests/test_torch_training.py);
  * `Predictor.from_checkpoint(<dir>)` against JAX's on the same
    directory: 2e-5 (one forward, f32 products in another order).
"""

import glob
import json
import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training import checkpoint as jck
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch import cli
from ggnn_tpu_torch.native import codec
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training import checkpoint, orbax_dir
from ggnn_tpu_torch.training import runner as runner_mod
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import Runner

zstandard = pytest.importorskip("zstandard")

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "orbax", "sparse_h32")
SMALL = {"hidden_size": 8, "layer_timesteps": [2, 1],
         "residual_connections": {"1": [0]}, "num_epochs": 1,
         "random_seed": 3}
NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
TRAIN = synthetic_molecules(40, seed=0)
VALID = synthetic_molecules(12, seed=1)
QUIET = dict(log=lambda *a: None)


# ------------------------------------------------------ frame inspection

def _block_features(block: bytes) -> set:
    """The literal and sequence kinds of one compressed block."""
    kinds = ("raw", "rle", "compressed", "treeless")
    lit, fmt = block[0] & 3, (block[0] >> 2) & 3
    out = {("literals", kinds[lit])}
    if lit < 2:
        if fmt in (0, 2):
            hdr, size = 1, block[0] >> 3
        elif fmt == 1:
            hdr, size = 2, (block[0] >> 4) + (block[1] << 4)
        else:
            hdr, size = 3, ((block[0] >> 4) + (block[1] << 4)
                            + (block[2] << 12))
        pos = hdr + (size if lit == 0 else 1)
    else:
        hdr = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
        h = int.from_bytes(block[:hdr], "little")
        comp = {3: (h >> 14) & 0x3FF, 4: (h >> 18) & 0x3FFF,
                5: (h >> 22) & 0x3FFFF}[hdr]
        out.add(("streams", 1 if fmt == 0 else 4))
        if lit == 2:
            out.add(("huffman weights",
                     "direct" if block[hdr] >= 128 else "fse"))
        pos = hdr + comp
    nseq = block[pos]
    pos += 1
    if nseq == 0:
        out.add(("sequences", "none"))
        return out
    pos += 2 if nseq == 255 else (1 if nseq >= 128 else 0)
    modes = block[pos]
    names = ("predefined", "rle", "fse", "repeat")
    for field, shift in (("literal lengths", 6), ("offsets", 4),
                         ("match lengths", 2)):
        out.add(("sequences", names[(modes >> shift) & 3]))
    return out


def frame_features(data: bytes) -> set:
    """Every block, literal and sequence kind in a buffer of frames."""
    out, pos = set(), 0
    while pos < len(data):
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            out.add(("frame", "skippable"))
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            continue
        assert magic == 0xFD2FB528
        fhd = data[pos + 4]
        single, fcs, checksum = (fhd >> 5) & 1, fhd >> 6, (fhd >> 2) & 1
        p = pos + 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
        p += (1 if single else 0, 2, 4, 8)[fcs]
        if checksum:
            out.add(("frame", "checksum"))
        if single or fcs:
            out.add(("frame", "content size"))
        while True:
            bh = int.from_bytes(data[p:p + 3], "little")
            p += 3
            last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
            out.add(("block", ("raw", "rle", "compressed")[kind]))
            if kind == 1:
                p += 1
            else:
                if kind == 2:
                    out |= _block_features(data[p:p + size])
                p += size
            if last:
                break
        pos = p + (4 if checksum else 0)
    return out


# --------------------------------------------------------------- zstd

def _buffers():
    rng = np.random.default_rng(0)
    text = open(os.path.join(os.path.dirname(HERE), "ggnn_tpu_torch",
                             "native", "zstd.cpp"), "rb").read()
    # A random block, then copies of its start with every 37th byte set:
    # each later sequence alike (sequences in RLE mode at level 1).
    head = rng.integers(0, 255, 131_072, dtype=np.uint8)
    edited = np.tile(head[:1000], 200)
    edited[::37] = 255
    return {
        "periodic edits": np.concatenate([head, edited]).tobytes(),
        "zeros": bytes(300_000),
        "repeated": b"ggnn " * 40_000,
        "random f32": rng.standard_normal(60_000).astype(np.float32)
        .tobytes(),
        "rounded f32": (rng.standard_normal(60_000) * 0.01).round(3)
        .astype(np.float32).tobytes(),
        "low entropy": rng.integers(0, 5, 200_000, dtype=np.uint8)
        .tobytes(),
        "text": text * 4,
        "tiny": b"abc",
        "empty": b"",
    }


BUFFERS = _buffers()
FEATURES_SEEN = set()


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_decoder_matches_zstandard(level, checksum, content_size):
    compressor = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size)
    for name, data in BUFFERS.items():
        frame = compressor.compress(data)
        FEATURES_SEEN.update(frame_features(frame))
        assert codec.decompress(frame) == data, name


# A compressed block of RLE literals and no sequences, written by hand
# (zstandard's encoder prefers a treeless or Huffman section): "x" x 20.
RLE_LITERALS_FRAME = (b"\x28\xb5\x2f\xfd\x20\x14"
                      + ((3 << 3) | (2 << 1) | 1).to_bytes(3, "little")
                      + bytes([(20 << 3) | 1]) + b"x" + bytes([0]))


def test_hand_made_rle_literals_frame():
    want = zstandard.ZstdDecompressor().decompressobj().decompress(
        RLE_LITERALS_FRAME)
    assert want == b"x" * 20
    assert codec.decompress(RLE_LITERALS_FRAME) == want
    assert ("literals", "rle") in frame_features(RLE_LITERALS_FRAME)


def test_decoder_cases_cover_every_block_and_literal_kind():
    """The frames of the cases above (each level also compressed here
    again, so this test stands alone) hold every block kind, every
    literal kind, both stream counts, both Huffman weight forms and
    every sequence mode."""
    seen = set(FEATURES_SEEN) | frame_features(RLE_LITERALS_FRAME)
    for level in (1, 3, 19):
        for data in BUFFERS.values():
            seen |= frame_features(
                zstandard.ZstdCompressor(level=level).compress(data))
    # Blocks of one byte repeated only come from the writer here.
    seen |= frame_features(codec.compress(BUFFERS["zeros"]))
    want = {("block", k) for k in ("raw", "rle", "compressed")}
    want |= {("literals", k) for k in ("raw", "rle", "compressed",
                                       "treeless")}
    want |= {("streams", 1), ("streams", 4), ("huffman weights", "fse"),
             ("huffman weights", "direct")}
    want |= {("sequences", k) for k in ("none", "predefined", "rle", "fse",
                                        "repeat")}
    assert want <= seen, sorted(want - seen)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(chunks=st.lists(st.tuples(st.binary(min_size=0, max_size=64),
                                 st.integers(1, 300)), max_size=40),
       noise=st.binary(max_size=2000), level=st.sampled_from([1, 3, 9, 19]),
       checksum=st.booleans())
def test_decoder_matches_zstandard_on_random_inputs(chunks, noise, level,
                                                    checksum):
    data = b"".join(c * n for c, n in chunks) + noise
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(data)
    assert codec.decompress(frame) == data


def test_several_frames_and_skippable_frames():
    a, b = BUFFERS["text"], BUFFERS["random f32"]
    skippable = ((0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little")
                 + b"12345")
    data = (zstandard.ZstdCompressor(level=3).compress(a) + skippable
            + zstandard.ZstdCompressor(level=1, write_checksum=True)
            .compress(b) + codec.compress(a))
    assert codec.decompress(data) == a + b + a


def test_decoder_refuses_what_it_cannot_decode():
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        BUFFERS["text"])
    with pytest.raises(codec.ZstdError, match="checksum"):
        codec.decompress(frame[:-1] + bytes([frame[-1] ^ 1]))
    with pytest.raises(codec.ZstdError):
        codec.decompress(frame[:len(frame) // 2])
    with pytest.raises(codec.ZstdError, match="magic"):
        codec.decompress(b"not a frame at all")
    dictionary = zstandard.train_dictionary(
        4096, [BUFFERS["text"][i:i + 400] for i in range(0, 80_000, 400)])
    with_dict = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        BUFFERS["text"][:5000])
    with pytest.raises(codec.ZstdError, match="dictionary"):
        codec.decompress(with_dict)


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_port_frames_decode_with_zstandard(name):
    data = BUFFERS[name]
    frame = codec.compress(data)
    kinds = {k for k in frame_features(frame) if k[0] == "block"}
    assert kinds <= {("block", "raw"), ("block", "rle")}
    got = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
    assert got == data
    assert codec.decompress(frame) == data


def test_crc32c_matches_google_crc32c():
    google_crc32c = pytest.importorskip("google_crc32c")
    for data in BUFFERS.values():
        assert codec.crc32c(data) == google_crc32c.value(data)
    # The check value of CRC-32C.
    assert codec.crc32c(b"123456789") == 0xE3069283


def test_the_decoder_builds_from_its_source(tmp_path, monkeypatch):
    from ggnn_tpu_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.build(native.ZSTD_SOURCE)
    assert path.exists() and path.name.startswith("libzstd_")
    assert path.parent == tmp_path


# ----------------------------------------------------- OCDBT and zarr v2

ts = pytest.importorskip("tensorstore")


def _ts_kvstore(root, config=None):
    spec = {"driver": "ocdbt", "base": f"file://{root}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def test_reader_walks_interior_nodes_written_by_tensorstore(tmp_path):
    """Small nodes force interior levels; small inline limits put most
    values in data files; a second transaction adds a version."""
    root = str(tmp_path / "db")
    kv = _ts_kvstore(root, {"max_decoded_node_bytes": 300,
                            "max_inline_value_bytes": 20,
                            "compression": {"id": "zstd", "level": 5}})
    rng = np.random.default_rng(1)
    want = {}
    for batch in range(2):
        with ts.Transaction() as txn:
            for k in range(80):
                key = f"arr{k % 7}/{k:03d}.{batch}".encode()
                value = rng.integers(0, 256, int(rng.integers(0, 90)),
                                     dtype=np.uint8).tobytes()
                kv.with_transaction(txn)[key] = value
                want[key] = value
    got = orbax_dir.read_database(root)
    assert got == want
    heights = []
    orig = orbax_dir._read_node

    def spy(files, ref, prefix, out):
        heights.append(ref[3])
        return orig(files, ref, prefix, out)
    orbax_dir._read_node = spy
    try:
        orbax_dir.read_database(root)
    finally:
        orbax_dir._read_node = orig
    assert max(heights) >= 2


def test_tensorstore_reads_the_port_database(tmp_path):
    root = str(tmp_path / "db")
    rng = np.random.default_rng(2)
    items = {f"k/{i:04d}".encode(): rng.integers(
        0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
        for i in range(200)}
    os.makedirs(root)
    orbax_dir.write_database(root, items)
    kv = _ts_kvstore(root)
    assert sorted(kv.list().result()) == sorted(items)
    for key, value in items.items():
        assert kv.read(key).result().value == value


def test_zarr_arrays_against_tensorstore(tmp_path):
    """tensorstore's zarr v2 arrays in an OCDBT store, several chunks and
    missing all-fill chunks among them, read by the port; the port's
    arrays, bf16 included, read by tensorstore."""
    root = str(tmp_path / "z")
    rng = np.random.default_rng(3)
    arrays = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": np.zeros((6,), np.int32),
              "c": np.asarray(5, np.int32),
              "d": rng.standard_normal((3, 4, 2)).astype(np.float64)}
    arrays["a"][:4, :3] = 0.0            # an all-fill chunk
    chunks = {"a": [4, 3], "b": [4], "c": [], "d": [2, 4, 2]}
    for name, value in arrays.items():
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{root}/", "path": name + "/"},
            "metadata": {"dtype": value.dtype.str, "shape": value.shape,
                         "chunks": chunks[name], "fill_value": 0,
                         "compressor": {"id": "zstd", "level": 3}},
            "create": True}).result()
        store.write(value).result()
    kv = orbax_dir.read_database(root)
    assert b"a/0.0" not in kv and b"b/0" not in kv    # left out as fill
    for name, value in arrays.items():
        got = orbax_dir._decode_array(name, kv)
        assert got.dtype == value.dtype and got.shape == value.shape
        np.testing.assert_array_equal(got, value)

    out = str(tmp_path / "port")
    bf16 = torch.randn(3, 4, dtype=torch.bfloat16)
    orbax_dir.write_arrays(out, {**arrays, "e": bf16})
    for name, value in arrays.items():
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{out}/",
            "path": name + "/"}}).result()
        np.testing.assert_array_equal(store.read().result(), value)
    store = ts.open({"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{out}/", "path": "e/"}}).result()
    assert store.dtype.name == "bfloat16"
    back = orbax_dir.read_arrays(out)["e"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, bf16)
    np.testing.assert_array_equal(
        np.asarray(store.read().result()).view(np.uint16),
        bf16.view(torch.int16).numpy().view(np.uint16))


def test_unsupported_layouts_are_refused_by_name(tmp_path):
    path = str(tmp_path / "c")
    orbax_dir.write_arrays(path, {"w": np.ones(3, np.float32)})
    meta_path = os.path.join(path, "_METADATA")
    meta = json.load(open(meta_path))
    json.dump({**meta, "use_zarr3": True}, open(meta_path, "w"))
    with pytest.raises(orbax_dir.OrbaxFormatError, match="use_zarr3"):
        orbax_dir.read_arrays(path)
    json.dump(meta, open(meta_path, "w"))
    kv = orbax_dir.read_database(path)
    zarray = json.loads(kv[b"w/.zarray"])
    kv[b"w/.zarray"] = json.dumps(
        {**zarray, "compressor": {"id": "blosc"}}).encode()
    with pytest.raises(orbax_dir.OrbaxFormatError, match="compressor"):
        orbax_dir._decode_array("w", kv)


# ---------------------------------------------- the committed fixture

def test_committed_jax_fixture_reads_bit_equal_to_its_pickle_twin():
    got = orbax_dir.read_arrays(FIXTURE)
    with open(FIXTURE + ".pickle", "rb") as f:
        twin = pickle.load(f)["weights"]
    assert sorted(got) == sorted(jck._sanitize(k) for k in twin)
    for key, value in twin.items():
        mine = got[jck._sanitize(key)]
        assert mine.dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(mine, np.asarray(value), err_msg=key)


def test_committed_jax_fixture_reads_as_tensorstore_reads_it():
    got = orbax_dir.read_arrays(FIXTURE)
    for name, value in got.items():
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{FIXTURE}/",
            "path": name + "/"}}, open=True, read=True).result()
        want = store.read().result()
        assert want.dtype == value.dtype, name
        np.testing.assert_array_equal(value, want, err_msg=name)


def test_committed_fixture_frames_exercise_the_decoder():
    """The fixture's chunks hold compressed blocks, Huffman literals and
    FSE-coded sequences, so reading it (chip_smoke.py phase 22, on a
    machine with no zstd library) runs the decoder's entropy stages."""
    kv = orbax_dir.read_database(FIXTURE)
    seen = set()
    for key, value in kv.items():
        if not key.endswith(b".zarray"):
            seen |= frame_features(value)
    assert {("block", "compressed"), ("literals", "compressed"),
            ("sequences", "fse")} <= seen, sorted(seen)
    assert any(k[0] == "sequences" and k[1] in ("predefined", "fse")
               for k in seen)
    assert os.path.isdir(os.path.join(FIXTURE, "ocdbt.process_0"))


# ------------------------------------------------- Runners, both ways

VARIANTS = {
    "sparse": ("sparse", {"batch_size": 300}),
    "rgcn": ("rgcn", {"batch_size": 300}),
    "dense": ("dense", {"batch_size": 8, "layer_timesteps": None,
                        "residual_connections": None,
                        "drop_remainder": False}),
    "sparse bf16": ("sparse", {"batch_size": 300,
                               "compute_dtype": "bfloat16"}),
}


def _variant_config(label, resolve=resolve_config):
    variant, extra = VARIANTS[label]
    cfg = {**SMALL, **extra}
    cfg = {k: v for k, v in cfg.items() if v is not None}
    if variant == "dense":
        cfg["num_timesteps"] = 2
    return variant, resolve(variant, config_json=json.dumps(cfg))


def _port_state(runner):
    out = {n: p.detach().numpy().copy()
           for n, p in runner.params.named_parameters()}
    out["count"] = np.asarray(runner.optimizer.count)
    for moment, state in (("mu", runner.optimizer.mu),
                          ("nu", runner.optimizer.nu)):
        out.update({f"{moment}.{n}": t.detach().numpy().copy()
                    for n, t in state.items()})
    return out


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)


def _jax_state(runner):
    return {k: np.asarray(v) for k, v in _flatten_named(
        jax.device_get(runner.state)).items()}


@pytest.mark.parametrize("label", sorted(VARIANTS))
def test_directories_cross_packages_bit_equal_to_pickles(label, tmp_path):
    """A trained port Runner saved as a directory and a pickle: the port
    restores the directory as it restores the pickle; JAX's
    `_load_payload` and `restore_checkpoint` read it as they read the
    pickle; the directory JAX's `save_checkpoint` writes of the state it
    restored comes back into the port as the trained state."""
    variant, config = _variant_config(label)
    kwargs = {}
    if variant == "dense":
        kwargs["valid_data"] = synthetic_molecules(16, seed=1)
    port = Runner(variant, dict(config), train_data=TRAIN,
                  valid_data=kwargs.get("valid_data", VALID),
                  log_dir=str(tmp_path / "p"), quiet=True, device="cpu",
                  tensorboard=False)
    port.train()
    want = _port_state(port)
    assert want["count"] > 0
    d, p = str(tmp_path / "ckpt"), str(tmp_path / "ckpt.pickle")
    for path in (d, p):
        checkpoint.save_checkpoint(path, port.config, port.params,
                                   port.train_step_id, port.valid_step_id,
                                   optimizer=port.optimizer)
    assert os.path.isdir(d) and not os.path.exists(d + ".tmp_new")

    def port_restore(path):
        r = Runner(variant, dict(config), train_data=TRAIN,
                   valid_data=kwargs.get("valid_data", VALID),
                   log_dir=str(tmp_path / "r"), quiet=True, device="cpu",
                   tensorboard=False, restore=path)
        assert r.train_step_id == port.train_step_id
        assert r.valid_step_id == port.valid_step_id
        return _port_state(r)

    _assert_equal(port_restore(d), want)
    _assert_equal(port_restore(p), want)

    payload_d, payload_p = jck._load_payload(d), jck._load_payload(p)
    assert payload_d["sanitized_keys"] is True
    assert payload_d["train_step"] == payload_p["train_step"]
    assert payload_d["valid_step"] == payload_p["valid_step"]
    _assert_equal({k: payload_d["weights"][jck._sanitize(k)]
                   for k in payload_p["weights"]}, payload_p["weights"])
    jax_config = dict(config)

    def jax_runner(path):
        return JaxRunner(variant, dict(jax_config), train_data=TRAIN,
                         valid_data=kwargs.get("valid_data", VALID),
                         log_dir=str(tmp_path / "j"), quiet=True,
                         tensorboard=False, restore=path)

    from_dir, from_pickle = jax_runner(d), jax_runner(p)
    assert from_dir.train_step_id == from_pickle.train_step_id \
        == port.train_step_id
    _assert_equal(_jax_state(from_dir), _jax_state(from_pickle))

    jd = str(tmp_path / "jax_ckpt")
    jck.save_checkpoint(jd, from_dir.config, from_dir.state,
                        from_dir.train_step_id, from_dir.valid_step_id)
    _assert_equal(port_restore(jd), want)


@pytest.fixture(scope="module")
def small_runner(tmp_path_factory):
    root = tmp_path_factory.mktemp("small")
    config = resolve_config("sparse", config_json=json.dumps(
        {**SMALL, "batch_size": 300}))
    runner = Runner("sparse", dict(config), train_data=TRAIN,
                    valid_data=VALID, log_dir=str(root), quiet=True,
                    device="cpu", tensorboard=False)
    runner.train()
    return runner, root


def _save(runner, path, train_step=None, **kwargs):
    checkpoint.save_checkpoint(
        path, runner.config, runner.params,
        runner.train_step_id if train_step is None else train_step,
        runner.valid_step_id, optimizer=runner.optimizer, **kwargs)


def test_overwrite_config_mismatch_and_iterator_sidecar(small_runner,
                                                        tmp_path):
    runner, _ = small_runner
    path = str(tmp_path / "ckpt")
    _save(runner, path)
    _save(runner, path, train_step=runner.train_step_id + 7,
          iterator_state={"epoch": 2, "steps_done": 1,
                          "np_rng_state": np.random.RandomState(4)
                          .get_state(),
                          "torch_generator_state": torch.Generator()
                          .get_state().numpy()})
    assert not os.path.exists(path + ".tmp_old")
    _, ts_, vs = checkpoint.restore_checkpoint(path, runner.config,
                                               runner.params, **QUIET)
    assert ts_ == runner.train_step_id + 7 and vs == runner.valid_step_id
    bad = dict(runner.config)
    bad["hidden_size"] = 99
    with pytest.raises(AssertionError):
        checkpoint.restore_checkpoint(path, bad, runner.params, **QUIET)
    # The iterator state comes from the sidecar alone, in both packages.
    os.rename(os.path.join(path, "manifest.ocdbt"),
              os.path.join(path, "manifest.moved"))
    it = checkpoint.load_iterator_state(path)
    jax_it = jck.load_iterator_state(path)
    assert it["epoch"] == jax_it["epoch"] == 2
    assert it["steps_done"] == jax_it["steps_done"] == 1
    np.testing.assert_array_equal(it["np_rng_state"][1],
                                  np.random.RandomState(4).get_state()[1])
    assert it["torch_generator_state"].dtype == np.uint8


def test_key_collision_is_refused(small_runner, tmp_path, monkeypatch):
    runner, _ = small_runner
    real = checkpoint.jax_weights_from_params

    def colliding(params):
        out = real(params)
        key = next(iter(out))
        out[key.replace("['params']", "['params'].x")] = out[key]
        out[key.replace("['params']", "['params']['x']")] = out[key]
        return out
    monkeypatch.setattr(checkpoint, "jax_weights_from_params", colliding)
    with pytest.raises(ValueError, match="collision"):
        _save(runner, str(tmp_path / "ckpt"))
    assert not os.path.exists(str(tmp_path / "ckpt"))


def test_legacy_sanitized_names_restore(small_runner, tmp_path):
    """A directory of the JAX package's older builds stores attribute
    segments dropped (`_sanitize_legacy`); restore finds its leaves."""
    runner, _ = small_runner
    weights = checkpoint.jax_weights_from_params(runner.params)
    freeze = checkpoint.optimizer_entries(runner.optimizer)
    # The frozen-graph optimizer's names hold attribute segments.
    frozen = {k.replace("['opt_state'][1]",
                        "['opt_state'].inner_states['train']"
                        ".inner_state[1]"): v for k, v in freeze.items()}
    path = str(tmp_path / "legacy")
    orbax_dir.write_arrays(path, {
        jck._sanitize_legacy(k): v for k, v in {**weights, **frozen}.items()})
    with open(os.path.join(path, "ggnn_meta.json"), "w") as f:
        json.dump({"params": runner.config, "train_step": 3,
                   "valid_step": 1, "sanitized_keys": True}, f)
    runner.optimizer.freeze_graph_model, was = True, \
        runner.optimizer.freeze_graph_model
    try:
        fresh = Runner("sparse", dict(runner.config), train_data=TRAIN,
                       valid_data=VALID, log_dir=str(tmp_path / "f"),
                       quiet=True, device="cpu", tensorboard=False)
        fresh.optimizer.freeze_graph_model = True
        logs = []
        checkpoint.restore_checkpoint(path, runner.config, fresh.params,
                                      log=logs.append,
                                      optimizer=fresh.optimizer)
    finally:
        runner.optimizer.freeze_graph_model = was
    assert not any("not used" in m or "Freshly" in m for m in logs), logs
    _assert_equal({n: p.detach().numpy() for n, p in
                   fresh.params.named_parameters()},
                  {n: p.detach().numpy() for n, p in
                   runner.params.named_parameters()})
    for name, t in runner.optimizer.nu.items():
        assert torch.equal(fresh.optimizer.nu[name], t)


def test_staged_directory_recovery_and_incomplete_staging(small_runner,
                                                          tmp_path):
    runner, _ = small_runner
    path = str(tmp_path / "ckpt")
    _save(runner, path)
    os.rename(path, path + ".tmp_new")
    for load in (checkpoint._load_payload, jck._load_payload):
        assert load(path)["train_step"] == runner.train_step_id
    os.remove(os.path.join(path + ".tmp_new", "ggnn_meta.json"))
    for load in (checkpoint._load_payload, jck._load_payload):
        with pytest.raises(FileNotFoundError, match="INCOMPLETE"):
            load(path)


def test_cli_restores_a_directory(small_runner, tmp_path, capsys):
    runner, _ = small_runner
    path = str(tmp_path / "ckpt")
    _save(runner, path)
    args = ["sparse", "--synthetic", "60", "--device", "cpu", "--config",
            json.dumps({**SMALL, "batch_size": 300}), "--log_dir",
            str(tmp_path / "log"), "--quiet", "--restore", path,
            "--evaluate"]
    capsys.readouterr()
    assert cli.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    assert len([line for line in out if line.startswith("[[")]) >= 7


# ------------------------------------------------ resume and serving

def _capture_dirs(module, out_dir):
    """A stand-in for `module.save_checkpoint` that copies each rolling
    directory checkpoint with an iterator state to out_dir/<e>_<s>."""
    save = module.save_checkpoint

    def capture(path, *args, iterator_state=None, **kwargs):
        save(path, *args, iterator_state=iterator_state, **kwargs)
        if iterator_state is not None and os.path.isdir(path):
            key = (iterator_state["epoch"], iterator_state["steps_done"])
            shutil.copytree(path, os.path.join(out_dir, "%d_%d" % key))
    return capture


def test_mid_epoch_resume_from_a_directory(tmp_path, monkeypatch):
    config = {**SMALL, **NO_DROPOUT, "batch_size": 120, "num_epochs": 2}
    port_cfg = resolve_config("sparse", config_json=json.dumps(config))
    jax_cfg = jax_resolve_config("sparse", config_json=json.dumps(config))
    jax_ref = JaxRunner("sparse", dict(jax_cfg), train_data=TRAIN,
                        valid_data=VALID, log_dir=str(tmp_path / "jref"),
                        quiet=True, tensorboard=False)
    init = params_from_jax_weights(_flatten_named(
        {"params": jax_ref.state["params"]}))
    jax_ref.train()
    jax_params = {n: t.numpy() for n, t in params_from_jax_weights(
        _flatten_named({"params": jax_ref.state["params"]})).items()}

    def port_runner(name, **kwargs):
        return Runner("sparse", dict(port_cfg), train_data=TRAIN,
                      valid_data=VALID, log_dir=str(tmp_path / name),
                      quiet=True, device="cpu", tensorboard=False, **kwargs)

    interrupted = port_runner("int", checkpoint_every_steps=1)
    interrupted.params.load_state_dict(init)
    interrupted.last_model_file = str(tmp_path / "rolling")
    (tmp_path / "kept").mkdir()
    monkeypatch.setattr(runner_mod, "save_checkpoint",
                        _capture_dirs(runner_mod, str(tmp_path / "kept")))
    interrupted.train()
    monkeypatch.undo()
    kept = str(tmp_path / "kept" / "2_1")
    assert checkpoint.load_iterator_state(kept)["steps_done"] == 1
    uninterrupted = {n: p.detach().numpy().copy()
                     for n, p in interrupted.params.named_parameters()}

    resumed = port_runner("resumed", restore=kept)
    assert [e["epoch"] for e in resumed.train()] == [2]
    got = {n: p.detach().numpy() for n, p in resumed.params.named_parameters()}
    for name in uninterrupted:
        np.testing.assert_allclose(got[name], uninterrupted[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got[name], jax_params[name], rtol=5e-4,
                                   atol=5e-5, err_msg=name)
    in_jax = JaxRunner("sparse", dict(jax_cfg), train_data=TRAIN,
                       valid_data=VALID, log_dir=str(tmp_path / "jres"),
                       quiet=True, tensorboard=False, restore=kept)
    assert [e["epoch"] for e in in_jax.train()] == [2]
    jax_resumed = {n: t.numpy() for n, t in params_from_jax_weights(
        _flatten_named({"params": in_jax.state["params"]})).items()}
    for name in jax_params:
        np.testing.assert_allclose(jax_resumed[name], jax_params[name],
                                   rtol=5e-4, atol=5e-5, err_msg=name)


def test_predictor_serves_a_directory_as_jax_does():
    graphs = synthetic_molecules(7, seed=5)
    got = Predictor.from_checkpoint(FIXTURE, "sparse", device="cpu")(graphs)
    want = np.asarray(JaxPredictor.from_checkpoint(FIXTURE, "sparse")(graphs))
    assert np.asarray(got).shape == want.shape == (1, 7)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------- mesh

@pytest.mark.parametrize("over", [{}, {"edge_parallelism": "type_tp"}])
def test_mesh_saves_once_with_whole_leaves(tmp_path, over):
    """A 2-rank gloo mesh: every rank calls the save, rank 0 alone writes
    the directory, and under type-TP its leaves are whole (each edge
    rank's slices gathered first)."""
    sys.path.insert(0, HERE)
    import torch_mesh_ranks as ranks
    from ggnn_tpu_torch.parallel.launch import RankPool
    config = resolve_config("sparse", config_json=json.dumps(
        {**SMALL, **NO_DROPOUT, "batch_size": 120, "native_pack": False,
         **over}))
    path = str(tmp_path / "mesh_ckpt")
    with RankPool(2, "gloo", python_path=[HERE], timeout=300) as pool:
        results = pool.run(ranks.mesh_orbax_save, "sparse", config, TRAIN,
                           VALID, 1, 2, str(tmp_path / "log"), path)
    assert [r["wrote"] for r in results] == [1, 0]
    assert results[0]["kind"] == ("sparse_tp" if over else "sparse")
    saved = orbax_dir.read_arrays(path)
    whole = results[0]["weights"]
    for name, value in whole.items():
        key = jck._sanitize(checkpoint._keystr(name))
        assert saved[key].shape == value.shape
        np.testing.assert_array_equal(saved[key], value, err_msg=name)
    assert not glob.glob(path + ".tmp_*")
