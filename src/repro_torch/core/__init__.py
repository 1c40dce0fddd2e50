"""Cache runtimes of the port: host tier, planner, scratchpad, serving."""
