"""Labs for the H100: the codec's copy floor and layout sweep, the radix-sort
ingredients, and the device-capacity and feed labs.

:mod:`ibu_tpu_torch.labs.sol_lab` and :mod:`ibu_tpu_torch.labs.kernel_lab`
are the Hopper counterparts of ``tools/sol_lab.py`` and
``tools/kernel_lab.py``, each runnable as ``python -m``; they share inputs,
the host oracle, timing and byte accounting (:mod:`._harness`) and the lab
kernels' wrappers and plain versions (:mod:`._kernels`).
:mod:`ibu_tpu_torch.labs.sort_lab` is the counterpart of
``tools/pallas_sort_lab.py``. The device-capacity labs
(:mod:`.engine_capacity_lab`, :mod:`.histogram_capacity_lab`,
:mod:`.molcount_capacity_lab`, :mod:`.sort_keys_lab`) time the production
engines on batches already on the card, and the feed labs
(:mod:`.stream_lab`, :mod:`.put_sweep`, :mod:`.put_source_lab`) the way
records reach it; they share :mod:`._capacity`. The labs measure and change
nothing in the production code.
"""
