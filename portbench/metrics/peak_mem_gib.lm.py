"""The card's peak of allocated memory inside the window
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its start),
in GiB."""

from portbench.metrics._common import peak_mem_gib as read  # noqa: F401
