"""Host calls a frame of the class pipeline: the kernel launches the host
issues itself and the stage graphs' replays, counted by the program
(``kernels/_lib.host_calls``) over every frame of the window."""


def read(ctx):
    return ctx["host_calls"]
