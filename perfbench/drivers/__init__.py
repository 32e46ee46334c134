"""One module per kind of step a cell's window drives. Each has `Run(cell,
cfg, seed, device)`: set-up (the corpus, the weights, the program's
objects), `first_steps(n)` (the steps that `correct` follows, read into
`readings`), `step()` (one step of the window, dispatched without a
synchronise), `free()` (the program's state dropped), `reference(rounding, half,
frozen)` (the plain reference over the same first steps, in f32 or fp8,
or with a fault planted), `batch` (samples a step) and `counts`
(`perfbench/counts`)."""
