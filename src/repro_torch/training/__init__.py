"""Training-side infrastructure the serving path reuses: on-disk
checkpoints (the denoise snapshots of ``core/failures.py``)."""
