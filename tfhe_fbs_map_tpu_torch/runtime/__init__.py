from .executor import CircuitExecutor, compile_program

__all__ = ["CircuitExecutor", "compile_program"]
