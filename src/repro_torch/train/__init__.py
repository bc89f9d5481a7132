"""Training subsystem of the port.

  optimizer.py  — dense AdamW and ``make_optimizer`` (sketched AdamW from
                  sketch/optimizer.py when the config asks for it)
  data.py       — stateless-seeded synthetic LM batches
  checkpoint.py — atomic npz + manifest + LATEST checkpoints
  loop.py       — ``train()``: step loop, straggler monitor, spike record,
                  checkpoint cadence and resume
"""
