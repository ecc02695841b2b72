"""GTP v2 front end of the PyTorch port: the Agent (engine.py), the
protocol loop (loop.py) and the clock (time_control.py)."""
