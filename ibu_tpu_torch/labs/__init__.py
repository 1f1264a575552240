"""Codec labs for the H100: the card's copy floor and the codec's layout sweep.

:mod:`ibu_tpu_torch.labs.sol_lab` and :mod:`ibu_tpu_torch.labs.kernel_lab`
are the Hopper counterparts of ``tools/sol_lab.py`` and
``tools/kernel_lab.py``, each runnable as ``python -m``; they share inputs,
the host oracle, timing and byte accounting (:mod:`._harness`) and the lab
kernels' wrappers and plain versions (:mod:`._kernels`). They measure and
change nothing in the production codec.
"""
