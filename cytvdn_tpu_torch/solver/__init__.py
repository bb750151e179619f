from cytvdn_tpu_torch.solver.engine import run_solver

__all__ = ["run_solver"]
