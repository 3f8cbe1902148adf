"""The benchmark's plain reference: the port's plain CPU path, frozen and
standing alone, in plain PyTorch.

Each module is a copy of the module of ``ergodic_exploration_tpu_torch`` of
the same path at commit e20fa1114c5b (``grid.py``, ``config.py``,
``controller.py``, ``models/``, ``ops/basis.py``, ``barrier.py``,
``buffer.py``, ``collision.py``, ``distance.py``, ``dwa.py``,
``integrator.py``, ``patch.py``, ``sensor.py``, ``target.py``, the plain
versions of ``edt_kernel.py``, ``gmm_kernel.py``, ``mi_kernel.py``,
``mi_dense_kernel.py``, ``solve_kernel.py`` and ``tick_glue.py``,
``utils/prng.py``, ``numerics.py``, ``device.py``), with its imports
pointed here, the CUDA dispatch and the kernels' launchers removed (every
function is its plain version, on whatever device its inputs lie) and what
no cell uses taken out; ``engine.py`` is the engine's entry points as plain
loops. It imports nothing of the program and takes nothing the program has
made: the harness hands it the same arrays it hands the program.
"""
