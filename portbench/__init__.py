"""The PyTorch and CUDA port's benchmark (``repro_torch``, served on one
card).

Run from the root of a checkout::

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells, configurations and
metrics; every cell, configuration and metric lives in files of its own
here and is found by its name:

* ``configs/<name>.json``: a configuration's sizes as run, its source,
  what was cut and what was assumed; ``family`` names its modules below;
* ``models/<family>.py``: the port's ``ModelConfig`` for it and the
  benchmark's weight layout, mapped to the port's parameter names;
* ``reference/<family>.py``: the plain float32 forward the served tokens
  are judged by (it imports nothing of the port);
* ``count/<family>.py``: model FLOPs and least bytes from the shapes;
* ``traffic/<mix>.json``: a traffic mix, read by the one generator
  (``traffic.py``): its batch, prompt and output lengths (``batch``,
  ``prompt``, ``generate``), where the window closes (``close``), what a
  traced run profiles (``trace``), how many requests the reference judges
  (``check``), its small sizes for the CPU tests (``smoke``) and the
  public figures its lengths stand for (``source``);
* ``workloads/<cell>.json``: a cell's ``limits``, the limit of each
  number compared;
* ``metrics/<name>.py``: one reader a metric, taking its value from what
  the run recorded, or nothing where there is nothing to read.
"""
