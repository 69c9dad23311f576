"""The plain reference of a cell: the same semantics, written apart.

Plain PyTorch in float64 (or in any dtype it is given: the control runs
it in bfloat16). It imports nothing of the program, of the JAX package
or of JAX, and takes nothing the program made: the clump template,
lattice, materials, families and wildcards come from the configuration
(``portbench.lattice``), and the program's state enters only as the
input of the step the reference follows (owner poses and velocities,
the contact history the refresh carries).
"""
