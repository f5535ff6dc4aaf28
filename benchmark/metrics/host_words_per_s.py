"""train_words_per_s's reading, kept per layer in a cell where the host
sets the pace and its spread from run to run is wider than any bound: corpus
words consumed over the untraced window's wall time on the host's clock
(a traced run times that window before its traced epoch)."""

from benchmark.metrics.train_words_per_s import read  # noqa: F401
