"""The experiment harness of the PyTorch port, priced on the H100.

The port of the JAX package's ``experiments/`` drivers that make the
paper's table: :mod:`.sweep` maps every benchmark of a suite at every FBS
size p and prices each row with the port's optimizer and runtime model
(``python -m tfhe_fbs_map_tpu_torch.harness.sweep``);
:mod:`.reestimate_staged` recomputes the staged columns of a sweep's
aggregate; :mod:`.analyse` prints the tables over the aggregates and the
runtime CLI's measured runs.  Everything a run writes goes under its output
directory (default ``outputs/h100/<suite>/``, git-ignored).
"""
