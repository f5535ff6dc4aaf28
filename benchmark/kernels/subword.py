"""The ragged gather-mean of the subword model (word2bits_tpu_torch/csrc/
subword_mean.cu, `subword_mean_kernel`): one launch a step on the
`-model fasttext` engine, each center's mean of its quantized subword
rows G_w.  Its bytes: each center's |G_w| input rows read once (as
gathered), their int32 ids, the center's id and two offsets (int64), and
h [B, D] float32 written once; its operations the adds over those rows
and one divide a column.  |G_w| comes from the model module's bound
state (benchmark/fasttext.py `bind`) under the distribution of a word of
the subsampled stream.  A cell whose model has no subword rows reads
nothing."""

from benchmark import work

PATTERNS = [r"\bsubword_mean_kernel"]
EXCLUDE = []


def per_step(shape: work.StepShape):
    """(operations, bytes) the kernel's launch of one step needs, or None
    where the cell's model has no subword rows."""
    n_sub = getattr(shape.state, "n_sub", None)
    if n_sub is None:
        return None
    B, D = shape.B, shape.D
    rows = B * float((shape.p_kept * n_sub).sum())
    flops = rows * D + B * D
    nbytes = rows * (D * shape.elt + 4) + B * 3 * 8 + B * D * 4
    return flops, nbytes
