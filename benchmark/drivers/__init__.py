"""One driver per traffic kind: ``run(cell, args, hooks, device)``."""
