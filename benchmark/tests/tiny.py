"""Tiny overrides of each cell for runs of the whole harness on the CPU:
the same code paths, a few layers at narrow widths, small corpora and
short windows."""

import os

BERT = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 128,
        "marqo": {"model_properties": {"dimensions": 64}}}
CLIP = {"embed_dim": 32,
        "vision_cfg": {"image_size": 56, "layers": 2, "width": 64,
                       "patch_size": 14},
        "text_cfg": {"width": 64, "heads": 2, "layers": 2},
        "assumed": {"vision_cfg": {"head_width": 32}},
        "marqo": {"model_properties": {"dimensions": 32}}}
BASE = {"docs": 3000}

OVERRIDES = {
    "e5_base.bulk_ingest": {
        "config": BERT,
        "traffic": {"base_corpus": BASE, "prebuilt_requests": 4,
                    "warmup_requests": 2, "docs_per_request": 32,
                    "check": {"sample": 6, "longest_of": 50}}},
    "e5_base.search": {
        "config": BERT,
        # the tiny encoder's bf16 rounding on the CPU moves scores by up to
        # 1.1e-4 RMS (the card's e5-base 4.9e-5); a query token altered,
        # 4.7e-3
        "traffic": {"base_corpus": BASE, "warmup_requests": 5, "rate": 20,
                    "check": {"sample": 8, "limits": {"score_rms": 5e-4}}}},
    # every acknowledged image compared, so that a fault in some images
    # alone is found whichever the sample would have drawn
    "vit_l14.bulk_ingest": {
        "config": CLIP,
        "traffic": {"prebuilt_requests": 4, "warmup_requests": 2,
                    "docs_per_request": 8, "documents": {"image_pool": 16},
                    "check": {"sample": 1000, "longest_of": 30}}},
}


# each cell's configuration file, for the cells that BENCHMARK.json does not
# hold: ViT-L/14's ingest, out while the program's resize departs from
# open_clip's, the search, out while its latency spreads too widely, and
# the ingest from four concurrent loaders, out while its rate swings from
# run to run
CONFIG_FILES = {"e5_base.bulk_ingest": "benchmark/configs/e5_base_v2.json",
                "e5_base.concurrent_ingest":
                    "benchmark/configs/e5_base_v2.json",
                "e5_base.search": "benchmark/configs/e5_base_v2.json",
                "vit_l14.bulk_ingest": "benchmark/configs/vit_l14.json"}


def run_cell(cell: str, seed: int, capsys, trace: int = 0,
             seconds: float = 2.0) -> tuple:
    """(exit code, last stdout line, stderr) of one tiny run on the CPU,
    from the repository's root."""
    import run as bench
    os.environ["MARQO_BEST_AVAILABLE_DEVICE"] = "cpu"
    cwd = os.getcwd()
    os.chdir(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    try:
        args = bench.parse(["--workload", cell, "--seed", str(seed),
                            "--seconds", str(seconds), "--trace", str(trace)])
        rc = bench.run(args, device="cpu", chips_check=False,
                       overrides=OVERRIDES[cell],
                       manifest=bench.with_cell(bench.load_manifest(), cell,
                                                CONFIG_FILES[cell]))
    finally:
        os.chdir(cwd)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (lines[-1] if lines else ""), err
