"""The planner of the paper's Figure 3 on PyTorch: problem model, analytic
tier (``mva``, ``milp``), accurate tier (``qn_sim`` on the ``qn_event``
kernel), the raced hill climber and the ``DSpace4Cloud`` facade."""
