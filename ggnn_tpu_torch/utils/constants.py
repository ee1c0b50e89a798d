"""Framework-wide numeric constants.

`SMALL_NUMBER` is the reference epsilon used in averaged message
aggregation and masked-loss denominators (reference: utils.py:8).
`CHEMICAL_ACCURACIES` are the 13 QM9 per-task chemical-accuracy
normalizers (in train-std-normalized units) used to report
``error_ratio = MAE / chemical_accuracy[task]``
(reference: chem_tensorflow.py:215-217).
"""

import numpy as np

SMALL_NUMBER = 1e-7

CHEMICAL_ACCURACIES = np.array(
    [
        0.066513725, 0.012235489, 0.071939046, 0.033730778, 0.033486113,
        0.004278493, 0.001330901, 0.004165489, 0.004128926, 0.00409976,
        0.004527465, 0.012292586, 0.037467458,
    ],
    dtype=np.float64,
)
