"""Configuration for word2bits_tpu_torch.

The same dataclass as the JAX package's config.py: the reference CLI's
flags and defaults (reference src/word2bits.cpp:48-59, flag names
:596-611) plus the JAX package's extensions, with the same field names,
defaults, validation, `auto_lr` and `config_from_argv`, so one argv
resolves to equal fields in both packages.  What each extension does is
documented there.  The port has four fields more: `neg_per_pair`
(`-neg-per-pair 1`, skip-gram's per-pair negatives as word2vec draws
them, models/skipgram.py), and fastText's `minn`, `maxn` and `bucket`
(`-minn`, `-maxn`, `-bucket`, the subword models `-model fasttext`,
models/subword.py, and `-model fasttext-cbow`, models/subword_cbow.py);
with those at their defaults and another model, every field equals the
JAX package's.

The port implements everything the JAX package runs: the
two CBOW engines, the split-table slab engine (the reference default:
per-center negatives; or shared ones, models/cbow_slab.py) with the `add`
or `span` scatter or the block dedup (`-dedup-block`), and the fused-table
engine (`-fused-tables 1 -neg-sharing G`, models/cbow_fused.py) with the
`add`, `span`, `grmw` or in-place RMW (`-rmw-scatter`) scatter, the block
dedup, and the hot/cold split (`-hot-rows`, `-hot-pallas`,
`-neg-stratify`, `-neg-dense-hot`), either with shifted-sum or banded
windowed sums, optionally the fused context kernel (`-context-pallas`) and
the fused score kernel (`-use-pallas`); skip-gram (`-model skipgram`,
`-cbow 0`, models/skipgram.py) on split tables; fastText's subword
skip-gram (`-model fasttext`, models/subword.py) on split tables whose
input table holds the n-gram buckets too, and fastText's CBOW with
position weights (`-model fasttext-cbow`, models/subword_cbow.py) on the
same tables and a third, the position weights; any `-loop-mode` (all three
run
the same in-place loop); the epoch built on the device
(`-device-epoch`, resolved by `device_epoch_on` as in the JAX package) or
on the host; the `-packed 1` export; checkpoint/resume (`-checkpoint-dir`,
`-resume`, `-checkpoint-every-epoch`, train.save_checkpoint); a
profiler trace of one steady chunk (`-profile-dir`); and the (data, vocab)
mesh trainer (`-mesh-shape`, `-hot-interleave`, parallel/), one process a
device.  A flag whose code the port lacks is rejected by name with a
ValueError, never ignored: see UNSUPPORTED below (now empty).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

# the models whose input table holds fastText's n-gram buckets
SUBWORD_MODELS = ("fasttext", "fasttext-cbow")


@dataclass(frozen=True)
class Word2BitsConfig:
    """Training configuration (field names/defaults follow the reference
    flags: -bitlevel 1 -size 100 -window 5 -negative 5 -alpha 0.05
    -sample 1e-3 -min-count 5 -threads 12 -iter 5 -reg 0 -binary 0
    -debug 2 -save-every-epoch 0 -classes 0)."""

    # --- file paths (reference -train/-output/-save-vocab/-read-vocab) ---
    train_file: Optional[str] = None
    output_file: Optional[str] = None
    save_vocab_file: Optional[str] = None
    read_vocab_file: Optional[str] = None

    # --- model ---
    bitlevel: int = 1          # quantization level; 0 = full precision
    size: int = 100            # embedding dimension
    window: int = 5            # max context half-width
    negative: int = 5          # negative samples per center word
    alpha: float = 0.05        # starting learning rate
    sample: float = 1e-3       # frequent-word subsampling threshold
    min_count: int = 5         # prune words rarer than this
    iter: int = 5              # epochs
    reg: float = 0.0           # L2 regularization on quantized params
    binary: bool = False       # output format: binary fp32 rows vs text
    packed: bool = False       # also write bit-packed vectors (.pack)
    debug: int = 2             # verbosity (2 = progress lines)
    save_every_epoch: bool = False
    classes: int = 0           # reference flag; nonzero -> empty output

    # --- execution (replaces reference -threads semantics) ---
    threads: int = 12          # accepted for CLI compat; not a knob
    batch_size: int = 0        # centers per synchronous step; 0 = auto (256)
    steps_per_chunk: int = 256 # steps per chunk call
    loop_mode: str = "scan"
    neg_sharing: int = 0       # shared-negative tile size G; 0 = per-center
    neg_pool: int = 1          # negative pools per tile
    fused_tables: bool = False # interleaved (V, 2D) table
    model: str = "cbow"
    neg_per_pair: bool = False  # skip-gram: K draws per (center, context)
    minn: int = 3              # fasttext: shortest n-gram, bytes of <word>
    maxn: int = 6              # fasttext: longest n-gram (0: no n-grams)
    bucket: int = 2_000_000    # fasttext: hash buckets of the n-grams
    use_pallas: bool = False
    dedup_block: int = 0
    hot_rows: int = 0
    neg_stratify: bool = False
    neg_dense_hot: bool = False
    hot_pallas: bool = False
    rmw_scatter: bool = False
    context_pallas: bool = False  # fused context + positive kernel
    banded_tile: int = 0          # banded windowed sums tile (0 = off)
    scatter_impl: str = "add"     # "add" | "span" | "grmw"
    span_window: int = 512
    span_chunk: int = 128
    hot_interleave: bool = True
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    checkpoint_every_epoch: bool = True
    segment_tokens: int = 1 << 28  # corpora beyond stream in segments
    device_epoch: Optional[bool] = None
    seed: int = 1
    init: str = "reference"    # "reference" (exact LCG parity) or "uniform"
    auto_lr: bool = True       # batch-aware LR factor (see lr_scale)
    dtype: str = "float32"     # backing-store dtype of the tables
    profile_dir: Optional[str] = None

    # --- sharding ---
    mesh_shape: Optional[dict] = None

    def __post_init__(self):
        self._validate()
        self._reject_unported()

    def _validate(self):
        """The JAX package's validation, check for check (the port's
        -neg-per-pair first)."""
        if self.batch_size == 0:
            object.__setattr__(self, "batch_size", 256)
        if self.neg_per_pair:
            self._validate_per_pair()
        if self.model in SUBWORD_MODELS:
            self._validate_fasttext()
        if self.bitlevel == 3:
            raise ValueError(
                "bitlevel=3 is rejected: the reference quantizer maps every "
                "value to 0 at bitlevel 3 (a bug-hole in "
                "reference src/word2bits.cpp:73-108). Use 0, 1, 2, or >=4."
            )
        if self.bitlevel < 0:
            raise ValueError(f"bitlevel must be >= 0, got {self.bitlevel}")
        if self.size <= 0:
            raise ValueError(f"size must be positive, got {self.size}")
        if self.window <= 0:
            raise ValueError(f"window must be positive, got {self.window}")
        if self.negative < 0:
            raise ValueError(f"negative must be >= 0, got {self.negative}")
        if self.iter <= 0:
            raise ValueError(f"iter must be positive, got {self.iter}")
        if self.min_count < 0:
            raise ValueError(f"min_count must be >= 0, got {self.min_count}")
        if self.batch_size <= 0:
            raise ValueError(
                f"batch_size must be positive, got {self.batch_size}")
        if self.neg_sharing < 0 or (self.neg_sharing and
                                    self.batch_size % self.neg_sharing):
            raise ValueError(
                f"neg_sharing ({self.neg_sharing}) must be 0 or divide "
                f"batch_size ({self.batch_size})")
        if self.use_pallas and not self.neg_sharing:
            raise ValueError("use_pallas requires neg_sharing > 0")
        if self.neg_pool < 1:
            raise ValueError(f"neg_pool must be >= 1, got {self.neg_pool}")
        if self.neg_pool > 1:
            if not self.neg_sharing:
                raise ValueError("neg_pool > 1 requires neg_sharing > 0")
            if self.neg_sharing % self.neg_pool:
                raise ValueError(
                    f"neg_pool ({self.neg_pool}) must divide neg_sharing "
                    f"({self.neg_sharing}) so every pool serves the same "
                    "number of centers")
        if self.use_pallas and self.model != "cbow":
            raise ValueError("use_pallas is implemented for the cbow model")
        if self.hot_rows < 0:
            raise ValueError(f"hot_rows must be >= 0, got {self.hot_rows}")
        if self.banded_tile < 0:
            raise ValueError(
                f"banded_tile must be >= 0, got {self.banded_tile}")
        if self.banded_tile and self.model != "cbow":
            raise ValueError("banded_tile is implemented for the CBOW "
                             "slab/fused/sharded paths")
        if self.hot_pallas and not self.hot_rows:
            raise ValueError("hot_pallas requires -hot-rows H")
        if self.hot_pallas and self.mesh_shape:
            raise ValueError("hot_pallas is single-chip only")
        if self.hot_rows:
            if self.mesh_shape:
                if not self.neg_dense_hot:
                    raise ValueError(
                        "with -mesh-shape, -hot-rows is only meaningful "
                        "together with -neg-dense-hot 1")
            elif self.model == "skipgram":
                if not self.neg_dense_hot:
                    raise ValueError(
                        "with -model skipgram, -hot-rows is only "
                        "meaningful together with -neg-dense-hot 1")
            else:
                if not (self.fused_tables and self.neg_sharing
                        and self.model == "cbow"):
                    raise ValueError(
                        "hot_rows requires the fused-table CBOW path "
                        "(-fused-tables 1 -neg-sharing G -model cbow)")
                if self.device_epoch and not self.neg_dense_hot:
                    raise ValueError(
                        "the hot/cold slab scatter split uses host-"
                        "precomputed cold positions, incompatible with "
                        "-device-epoch 1 (with -neg-dense-hot 1 the hot "
                        "boundary applies to negatives only and composes "
                        "with -device-epoch; the slab split then stays off)")
        if self.neg_stratify or self.neg_dense_hot:
            which = "neg_stratify" if self.neg_stratify else "neg_dense_hot"
            if self.neg_stratify and self.neg_dense_hot:
                raise ValueError(
                    "neg_stratify and neg_dense_hot are exclusive")
            if not self.hot_rows:
                raise ValueError(f"{which} requires -hot-rows H")
            if self.use_pallas:
                raise ValueError(f"{which} is not threaded into the Pallas "
                                 "score kernel; drop -use-pallas")
            if self.neg_dense_hot and self.bitlevel >= 4:
                warnings.warn(
                    "-neg-dense-hot at -bitlevel >= 4 measured 7+ analogy "
                    "points BELOW sampled negatives at reference-default "
                    "shapes (ACCEPTANCE.md); verify quality on your corpus "
                    "or drop -neg-dense-hot at fine grids", stacklevel=3)
            if self.neg_stratify and self.model != "cbow":
                raise ValueError("neg_stratify is implemented for the "
                                 "fused-table CBOW path only")
            if self.neg_stratify and self.negative < 2:
                raise ValueError("neg_stratify needs -negative >= 2")
        if self.scatter_impl not in ("add", "span", "grmw"):
            raise ValueError(f"unknown -scatter-impl {self.scatter_impl!r} "
                             "(supported: add, span, grmw)")
        if self.scatter_impl == "grmw":
            if self.mesh_shape:
                raise ValueError("-scatter-impl grmw is single-chip")
            if self.model != "cbow" or not (self.fused_tables
                                            and self.neg_sharing):
                raise ValueError(
                    "-scatter-impl grmw runs on the fused-table CBOW path "
                    "(-fused-tables 1 -neg-sharing G -model cbow)")
            if (self.rmw_scatter or self.dedup_block or self.hot_rows
                    or self.neg_stratify or self.neg_dense_hot
                    or self.use_pallas):
                raise ValueError(
                    "-scatter-impl grmw replaces the plain scatter; it "
                    "does not compose with rmw_scatter/dedup_block/"
                    "hot_rows/neg_stratify/neg_dense_hot/use_pallas")
            if self.span_chunk <= 0:
                raise ValueError("-span-chunk must be positive, "
                                 f"got {self.span_chunk}")
        if self.context_pallas:
            if self.mesh_shape:
                raise ValueError("-context-pallas is single-chip")
            if self.model != "cbow":
                raise ValueError("-context-pallas runs on the CBOW paths")
            if not self.banded_tile:
                raise ValueError("-context-pallas requires -banded-tile "
                                 "(the kernel consumes the banded masks)")
            if self.reg:
                raise ValueError("-context-pallas supports -reg 0 only")
        # -loop-mode is checked as in the JAX package but chooses nothing
        # here: the JAX modes differ in how XLA carries the table (lax.scan
        # double-buffers it), and the port's table is updated in place by
        # one Python loop whatever the mode
        if self.loop_mode not in ("scan", "fori", "unroll"):
            raise ValueError(f"unknown -loop-mode {self.loop_mode!r} "
                             "(supported: scan, fori, unroll)")
        if self.loop_mode != "scan":
            if self.mesh_shape:
                raise ValueError("-loop-mode applies to the single-chip "
                                 "fused CBOW chunk")
            if self.model != "cbow" or not (self.fused_tables
                                            and self.neg_sharing):
                raise ValueError(
                    "-loop-mode fori/unroll runs on the fused-table CBOW "
                    "path (-fused-tables 1 -neg-sharing G -model cbow)")
        if self.scatter_impl == "span":
            if self.model != "cbow":
                raise ValueError("-scatter-impl span runs on the CBOW "
                                 "paths only")
            if (self.rmw_scatter or self.dedup_block or self.hot_rows
                    or self.neg_stratify or self.neg_dense_hot
                    or self.use_pallas):
                raise ValueError(
                    "-scatter-impl span replaces the plain scatter; it does "
                    "not compose with rmw_scatter/dedup_block/hot_rows/"
                    "neg_stratify/neg_dense_hot/use_pallas")
            if self.span_window <= 0 or self.span_window % 16:
                raise ValueError("-span-window must be a positive multiple "
                                 f"of 16, got {self.span_window}")
            if self.span_chunk <= 0:
                raise ValueError("-span-chunk must be positive, "
                                 f"got {self.span_chunk}")
        if self.rmw_scatter:
            if self.model != "cbow":
                raise ValueError("rmw_scatter runs on the CBOW paths only")
            if not self.mesh_shape and not (self.fused_tables
                                            and self.neg_sharing):
                raise ValueError(
                    "single-chip rmw_scatter runs on the fused-table CBOW "
                    "path (-fused-tables 1 -neg-sharing G -model cbow)")
            if (self.use_pallas or self.dedup_block or self.hot_rows
                    or self.neg_stratify or self.neg_dense_hot):
                raise ValueError(
                    "rmw_scatter is the plain-scatter capacity path; it "
                    "does not compose with use_pallas/dedup_block/"
                    "hot_rows/neg_stratify/neg_dense_hot")
            if self.steps_per_chunk > 1 and self.loop_mode == "scan":
                warnings.warn(
                    "rmw_scatter with -steps-per-chunk > 1 runs the scan "
                    "path, which double-buffers the carried table (~2x peak "
                    "HBM) — the capacity benefit rmw_scatter exists for "
                    "needs -steps-per-chunk 1 or -loop-mode fori "
                    "(in-place while-loop carry)", stacklevel=3)
        if self.mesh_shape:
            if self.use_pallas:
                raise ValueError("use_pallas is single-chip only")
            if self.dedup_block:
                raise ValueError("dedup_block is single-chip only")
        if self.fused_tables and not self.neg_sharing:
            raise ValueError(
                "fused_tables requires -neg-sharing G (the fused (V, 2D) "
                "layout exists for the shared-negative path)")
        if self.init not in ("reference", "uniform"):
            raise ValueError(
                f"init must be 'reference' or 'uniform', got {self.init!r}")
        if self.model not in ("cbow", "skipgram") + SUBWORD_MODELS:
            raise ValueError("model must be 'cbow', 'skipgram', 'fasttext' "
                             f"or 'fasttext-cbow', got {self.model!r}")

    def _validate_per_pair(self):
        """-neg-per-pair 1 runs on the single-card skip-gram engine with
        the sampled negatives of each pair and the plain sorted scatter,
        and with nothing that shares or replaces them."""
        if self.model != "skipgram":
            raise ValueError("-neg-per-pair 1 runs with -model skipgram "
                             "(-cbow 0) only")
        for flag, on in (("-neg-sharing", self.neg_sharing),
                         ("-neg-pool > 1", self.neg_pool > 1),
                         ("-hot-rows", self.hot_rows),
                         ("-neg-dense-hot", self.neg_dense_hot),
                         ("-dedup-block", self.dedup_block),
                         ("-mesh-shape", self.mesh_shape)):
            if on:
                raise ValueError(f"-neg-per-pair 1 does not compose with "
                                 f"{flag}: each pair draws its own K "
                                 "negatives")

    def _validate_fasttext(self):
        """-model fasttext and fasttext-cbow run on the single-card subword
        engines: each pair's (fasttext) or each center's (fasttext-cbow)
        own K draws, the plain sorted scatter, and an export of word
        vectors that are means, so nothing that shares or replaces the
        draws or the scatter, and no bit-packed file."""
        if self.minn < 1 or self.maxn < 0 or (self.maxn
                                               and self.maxn < self.minn):
            raise ValueError(f"-minn {self.minn} -maxn {self.maxn}: need "
                             "1 <= minn <= maxn, or maxn 0 (no n-grams)")
        if self.maxn and self.bucket <= 0:
            raise ValueError(f"-bucket must be positive with n-grams, got "
                             f"{self.bucket}")
        for flag, on in (("-neg-per-pair 1", self.neg_per_pair),
                         ("-neg-sharing", self.neg_sharing),
                         ("-neg-pool > 1", self.neg_pool > 1),
                         ("-hot-rows", self.hot_rows),
                         ("-neg-dense-hot", self.neg_dense_hot),
                         ("-dedup-block", self.dedup_block),
                         ("-fused-tables", self.fused_tables),
                         ("-mesh-shape", self.mesh_shape),
                         ("-packed 1", self.packed)):
            if on:
                who = "center" if self.model == "fasttext-cbow" else "pair"
                raise ValueError(f"-model {self.model} does not compose "
                                 f"with {flag}: each {who} draws its own "
                                 "K negatives, the tables are split and a "
                                 "word's vector is the mean of its rows")

    @property
    def subword_buckets(self) -> int:
        """The bucket rows of the input table: -bucket with n-grams
        (-model fasttext or fasttext-cbow, -maxn > 0), else none."""
        return (self.bucket if self.model in SUBWORD_MODELS and self.maxn
                else 0)

    def _reject_unported(self):
        """Flags whose code the port does not have yet: rejected by name."""
        for flag, field, selected in UNSUPPORTED:
            if selected(getattr(self, field)):
                raise ValueError(
                    f"{flag} {getattr(self, field)!r} is not implemented "
                    "by word2bits_tpu_torch yet (ROADMAP.md, port queue)")
        if self.dtype not in DTYPES:
            raise ValueError(f"-dtype {self.dtype!r} is not supported "
                             f"(supported: {', '.join(DTYPES)})")

    @property
    def device_epoch_on(self) -> bool:
        """Resolved -device-epoch, as in the JAX package: AUTO (None) is on
        unless the config needs host-precomputed cold positions (-hot-rows
        without -neg-dense-hot).  On, each epoch is built on the training
        device (data/device_pipeline.py) and no cold map is built: under
        AUTO, -hot-rows -neg-dense-hot 1 keeps the plain slab scatter."""
        if self.device_epoch is None:
            return not (self.hot_rows and not self.neg_dense_hot)
        return bool(self.device_epoch)

    @property
    def fused_on(self) -> bool:
        """The fused (V, 2D) table engine runs: -fused-tables 1 on CBOW
        off a mesh (skip-gram and the mesh trainer keep split tables, as
        in the JAX package)."""
        return bool(self.fused_tables and self.neg_sharing
                    and self.model == "cbow" and not self.mesh_shape)

    @property
    def lr_scale(self) -> float:
        """Measured synchronous-minibatch LR factor relative to the
        reference's per-example Hogwild LR: 3x at bitlevel 2, 1.2x at
        bitlevel >= 8 (only 8 was measured), 1x otherwise."""
        if not self.auto_lr:
            return 1.0
        if self.bitlevel == 2:
            return 3.0
        if self.bitlevel >= 8:
            return 1.2
        return 1.0

    @property
    def effective_alpha(self) -> float:
        """The starting LR actually used by the training step."""
        return self.alpha * self.lr_scale


# backing-store dtypes of the tables (torch dtype names)
DTYPES = ("float32", "bfloat16")

# (flag, field, selects-unported-code) — each rejected by name
UNSUPPORTED: tuple = ()

# The reference flag spellings, for the CLI layer.
REFERENCE_FLAGS = {
    "-train": ("train_file", str),
    "-output": ("output_file", str),
    "-save-vocab": ("save_vocab_file", str),
    "-read-vocab": ("read_vocab_file", str),
    "-bitlevel": ("bitlevel", int),
    "-size": ("size", int),
    "-window": ("window", int),
    "-negative": ("negative", int),
    "-alpha": ("alpha", float),
    "-sample": ("sample", float),
    "-min-count": ("min_count", int),
    "-iter": ("iter", int),
    "-reg": ("reg", float),
    "-binary": ("binary", lambda s: bool(int(s))),
    "-debug": ("debug", int),
    "-save-every-epoch": ("save_every_epoch", lambda s: bool(int(s))),
    "-classes": ("classes", int),
    "-threads": ("threads", int),
    # Extensions beyond the reference:
    "-batch-size": ("batch_size", int),
    "-steps-per-chunk": ("steps_per_chunk", int),
    "-loop-mode": ("loop_mode", str),
    "-segment-tokens": ("segment_tokens", int),
    "-seed": ("seed", int),
    "-dtype": ("dtype", str),
    "-neg-sharing": ("neg_sharing", int),
    "-neg-pool": ("neg_pool", int),
    "-fused-tables": ("fused_tables", lambda s: bool(int(s))),
    "-model": ("model", str),
    "-neg-per-pair": ("neg_per_pair", lambda s: bool(int(s))),
    "-minn": ("minn", int),
    "-maxn": ("maxn", int),
    "-bucket": ("bucket", int),
    "-packed": ("packed", lambda s: bool(int(s))),
    "-checkpoint-dir": ("checkpoint_dir", str),
    "-checkpoint-every-epoch": ("checkpoint_every_epoch",
                                lambda s: bool(int(s))),
    "-resume": ("resume", lambda s: bool(int(s))),
    "-auto-lr": ("auto_lr", lambda s: bool(int(s))),
    "-use-pallas": ("use_pallas", lambda s: bool(int(s))),
    "-context-pallas": ("context_pallas", lambda s: bool(int(s))),
    "-device-epoch": ("device_epoch", lambda s: bool(int(s))),
    "-dedup-block": ("dedup_block", int),
    "-hot-rows": ("hot_rows", int),
    "-mesh-shape": ("mesh_shape", lambda s: {
        k.strip(): int(v) for k, v in
        (kv.split("=") for kv in s.split(",") if kv.strip())}),
    "-hot-pallas": ("hot_pallas", lambda s: bool(int(s))),
    "-hot-interleave": ("hot_interleave", lambda s: bool(int(s))),
    "-banded-tile": ("banded_tile", int),
    "-scatter-impl": ("scatter_impl", str),
    "-span-window": ("span_window", int),
    "-span-chunk": ("span_chunk", int),
    "-rmw-scatter": ("rmw_scatter", lambda s: bool(int(s))),
    "-neg-stratify": ("neg_stratify", lambda s: bool(int(s))),
    "-neg-dense-hot": ("neg_dense_hot", lambda s: bool(int(s))),
    "-profile-dir": ("profile_dir", str),
    # word2vec-style spelling: -cbow 1 == cbow, -cbow 0 == skipgram
    "-cbow": ("model", lambda s: "cbow" if int(s) else "skipgram"),
}


def config_from_argv(argv) -> Word2BitsConfig:
    """Parse a reference-style flag list (positional `-flag value` scan,
    reference src/word2bits.cpp:579-611) into a config; unknown tokens are
    ignored like the reference's ArgPos."""
    kwargs = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in REFERENCE_FLAGS:
            if i + 1 >= len(argv):
                raise SystemExit(f"Argument missing for {tok}")
            field, conv = REFERENCE_FLAGS[tok]
            kwargs[field] = conv(argv[i + 1])
            i += 2
        else:
            i += 1
    return Word2BitsConfig(**kwargs)
