"""Model definitions: conv DSL and stacks, layers, CVNet, evaluate."""
