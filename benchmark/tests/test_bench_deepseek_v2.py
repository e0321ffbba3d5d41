"""The DeepSeek-V2-Lite cell at a tiny size on the CPU: a whole run through
``run.with_cell`` with tiny overrides of the configuration and the
traffic, correct, untraced and traced; its tokenizer against the plain
byte-level BPE; and the readers of its device-trace metrics on a synthetic
trace of the kernels' names (the CPU's trace has no device operation)."""

import json
import os

import pytest

from conftest import REPO
from harness.trace import Trace

CELL = "dsv2_lite.bulk_ingest"
CONFIG_FILE = "benchmark/configs/deepseek_v2_lite.json"
NEW_METRICS = ("encode_mfu.dsv2", "attention_roofline.mla",
               "expert_roofline.moe", "expert_load_max.moe",
               "device_idle.dsv2_ingest")
# the tiny model keeps every mechanism (YaRN, MLA, a dense layer, experts
# with shared ones, a sharded checkpoint) at narrow widths
TINY = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
        "num_key_value_heads": 4, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
        "intermediate_size": 96, "moe_intermediate_size": 24,
        "n_routed_experts": 8, "num_experts_per_tok": 2,
        "vocab_size": 1200,
        "assumed": {"bos_token_id": 1000, "eos_token_id": 1001,
                    "vocabulary_words": 300, "layers_per_shard": 1},
        "marqo": {"model_properties": {"dimensions": 64}}}
OVERRIDES = {
    "config": TINY,
    # the tiny model in bf16 on the CPU departs from its float32 reference
    # by 0.0049-0.0055, its fp8 control by 0.058-0.068 (tiny runs on the
    # CPU): the limit between them, with three times room on either side
    "traffic": {"base_corpus": {"docs": 2000}, "prebuilt_requests": 4,
                "warmup_requests": 2, "docs_per_request": 8,
                "check": {"sample": 6, "longest_of": 40,
                          "limits": {"gap_title": 0.02, "gap_body": 0.02}}}}


def run_tiny(seed: int, capsys, trace: int = 0, control: bool = False):
    import run as bench
    os.environ["MARQO_BEST_AVAILABLE_DEVICE"] = "cpu"
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "4",
                "--trace", str(trace)] + (["--control"] if control else [])
        rc = bench.run(bench.parse(argv), device="cpu", chips_check=False,
                       overrides=OVERRIDES,
                       manifest=bench.with_cell(bench.load_manifest(), CELL,
                                                CONFIG_FILE))
    finally:
        os.chdir(cwd)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, json.loads(lines[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_is_correct(trace, capsys):
    rc, result, err = run_tiny(2147483800 + trace, capsys, trace)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["checks"]["chunk_mismatch"]["value"] == 0
    metrics = result["metrics"]
    if trace:
        # the host-side readers report on the CPU; the device-trace ones
        # have no device operation to read there (below: a synthetic trace)
        assert metrics["encode_mfu.dsv2"]["value"] > 0
        assert metrics["expert_load_max.moe"]["value"] >= 1
    else:
        assert {"setup_s", "ingest_docs_per_s"} <= set(metrics)


def test_tiny_control_is_refused(capsys):
    rc, result, err = run_tiny(2147483900, capsys, control=True)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


def test_tokenizer_matches_the_plain_byte_level_bpe(tmp_path):
    import run as bench
    from reference import byte_bpe, corpus
    with open(os.path.join(REPO, CONFIG_FILE)) as f:
        config = bench.merge(json.load(f), TINY)
    family = bench.load_module(os.path.join(REPO, "benchmark", "families",
                                            "deepseek_v2.py"), "family_dsv2")
    words, tokens, merges = family.vocabulary(config, 7)
    family._tokenizer_files(tokens, merges, config, str(tmp_path))
    from tokenizers import Tokenizer
    tok = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    plain = byte_bpe.ByteBPE(tokens, merges)
    spec = {"id_prefix": "d", "title_words": [4, 12],
            "body_lognormal": [5.3, 0.45], "body_clip": [64, 1024],
            "sentence_words": [6, 30]}
    for k in range(20):
        doc = corpus.text_document(7, k, words, spec)
        for text in (doc["title"], doc["body"]):
            assert tok.encode(text).ids == plain.encode(text, 10 ** 6)
    assert plain.encode("abc", 512)[0] == config["assumed"]["bos_token_id"]


class FakeWindow:
    """What the device-trace readers read: a trace, the reference's work,
    and the window's adds."""

    def __init__(self, trace, docs=3):
        self.trace = trace
        self.traffic = {"tensor_fields": ["title", "body"]}
        self.docs = docs

    def reference(self):
        return FakeReference()

    def acknowledged(self):
        return list(range(self.docs))

    def document(self, k):
        return {"title": "t", "body": "b"}

    def in_window(self):
        return [[0, 0.0, 1.0, 0, self.docs, 200, [], {}]]


class FakeReference:
    def work(self, doc, fields):
        return 4e9, 1e-6

    def expert_work(self, doc, fields):
        return 3e12

    def expert_weight_bytes(self):
        return 3.35e9


def test_device_trace_readers_on_the_kernels_names():
    import run as bench
    ns = 10 ** 6
    trace = Trace([
        ("void marqo_attention::attention_tile_kernel<__nv_bfloat16, 192, "
         "128, (anonymous namespace)::CausalSegmentMask>(...)", 0, 6 * ns),
        ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_"
         "sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShapeIN4cute5"
         "tupleIJiiiEEEEE...", 6 * ns, 26 * ns),
        ("void marqo_attention::attention_tile_kernel<__nv_bfloat16, 64, 64,"
         " (anonymous namespace)::SegmentMask>(...)", 26 * ns, 27 * ns)],
        [("host", 0, 40 * ns)], 0.04)
    window = FakeWindow(trace)
    read = {name: bench.load_module(
        os.path.join(REPO, "benchmark", "metrics", f"{name}.py"),
        f"metric_{name}").read for name in NEW_METRICS}
    # 3 docs x 1e-6 s of attention over 6 ms of the causal instances
    assert read["attention_roofline.mla"](window) == pytest.approx(0.05)
    # max(9e12 / 989e12, 1 ms) over 20 ms of grouped GEMMs
    assert read["expert_roofline.moe"](window) == pytest.approx(
        100 * 9e12 / 989e12 / 0.020)
    assert read["device_idle.dsv2_ingest"](window) == pytest.approx(
        100 * (1 - 0.027 / 0.04))
    # a trace without the kernels is an error, not a silent 0
    bare = FakeWindow(Trace([("gemm", 0, ns)], [("host", 0, ns)], 0.01))
    for name in ("attention_roofline.mla", "expert_roofline.moe"):
        with pytest.raises(RuntimeError):
            read[name](bare)


def family_module():
    import run as bench
    return bench.load_module(os.path.join(REPO, "benchmark", "families",
                                          "deepseek_v2.py"), "family_dsv2")


def test_stale_partial_weights_are_removed(tmp_path):
    """A run killed mid-write leaves its partial directory; the next run
    removes it, and leaves alone a live process's and other directories."""
    family = family_module()
    dead = 2 ** 22 + 12345  # above the kernel's largest pid
    names = [f"deepseek_v2-abc.partial-{dead}",
             f"deepseek_v2-abc.partial-{os.getpid()}", "deepseek_v2-abc",
             f"other.partial-{dead}"]
    for name in names:
        (tmp_path / name).mkdir()
    family.remove_stale_partials(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(names[1:])


def test_weights_refused_where_the_disk_is_short(tmp_path, monkeypatch):
    """Before a byte is written, a disk that cannot hold the weights and
    the spare is a clear error, not a failure part-way through."""
    import shutil
    import run as bench
    family = family_module()
    with open(os.path.join(REPO, CONFIG_FILE)) as f:
        config = bench.merge(json.load(f), TINY)
    needed = family.weight_bytes(config)
    monkeypatch.setattr(family, "CHECKOUT", str(tmp_path))
    short = shutil._ntuple_diskusage(10 ** 12, 10 ** 12,
                                     needed + family.DISK_SPARE_BYTES - 1)
    monkeypatch.setattr(shutil, "disk_usage", lambda path: short)
    with pytest.raises(SystemExit, match="do not fit"):
        family.ensure_weights(config, "cpu")
    parent = tmp_path / "build" / "benchmark_checkpoints"
    assert os.listdir(parent) == []


def test_weights_drawn_at_their_assumed_std():
    """The router at its own std, every other weight at weight_std,
    RMSNorm scales about 1."""
    import run as bench
    family = family_module()
    with open(os.path.join(REPO, CONFIG_FILE)) as f:
        config = json.load(f)
    assumed = config["assumed"]
    H, E, F = 64, 8, 24
    shapes = [("model.layers.1.mlp.gate.weight", (E, H)),
              ("model.layers.1.mlp.experts.3.down_proj.weight", (H, F)),
              ("model.layers.1.mlp.experts.3.gate_proj.weight", (F, H)),
              ("model.layers.1.mlp.shared_experts.down_proj.weight",
               (H, 2 * F)),
              ("model.layers.1.input_layernorm.weight", (4096,))]
    drawn = family._draw_shard(shapes, 5, assumed, "cpu")
    std = {name: float(t.float().std()) for name, t in drawn.items()}
    names = [name for name, _ in shapes]
    assert std[names[0]] == pytest.approx(assumed["router_std"], rel=0.15)
    for name in names[1:4]:
        assert std[name] == pytest.approx(assumed["weight_std"], rel=0.15)
    assert float(drawn[names[4]].float().mean()) == pytest.approx(1, abs=0.01)
    # the digest of the weights' directory follows each assumed std
    other = bench.merge(config, {"assumed": {"router_std": 0.02}})
    assert family.weights_dir(other) != family.weights_dir(config)
