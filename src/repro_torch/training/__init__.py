"""Training: the train step for every family (``train_loop``), AdamW,
gradient compression, the token pipeline, checkpoints and the resilient
trainer; ``train_lm`` is the command-line trainer."""
