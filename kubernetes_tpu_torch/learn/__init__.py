"""The learned scorer's host side (port of the JAX package's learn/):
``learn.checkpoint``, the versioned checkpoint format and the
mtime-polled hot-reload watcher the scheduler polls at sync time, and the
parameter half of ``learn.train`` (``init_params``, ``identity_params``).
The trainer, the replay dataset, regret and the retrain loop are the
training slice's (ROADMAP queue 1 item 18)."""
