"""Auto-tuning (paper §III-C): the design space (``space.py``), the
performance surrogate (``surrogate.py``), the Pareto tools (``pareto.py``),
the PPO explorer in PyTorch (``ppo.py``) and the online controller that
applies each pick to a live trainer and measures it (``controller.py``)."""
