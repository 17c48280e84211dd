"""The kinds of traffic: each module runs one kind, its parameters read from
a traffic file. ``setup(ctx)`` builds the program and warms the cell's
shapes; ``window(ctx, state)`` drives it for ``ctx.seconds``; ``judge(ctx,
state, window)`` frees the program's state, runs the reference and returns
each compared number with its limit."""
