"""The plain reference of the benchmark's cells: `common` holds the parts,
`trunk_<model>` each trunk, `dkt` the training steps and the eval head."""
