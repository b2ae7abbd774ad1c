"""The plain reference of the benchmark: NumPy only, and nothing of the
program under test.  ``lbf`` reads and evaluates a mapped program in
plaintext, ``lwe`` decrypts, ``check`` compares."""
