"""The plain reference: Spotlight's models, loss and optimizer written out in
plain PyTorch, and the comparisons that judge the port's answers.

Nothing here imports the port (``spotlight_tpu_torch``), JAX or the JAX
package, and nothing here takes what the port made: the harness hands both
sides the same seeded inputs and weights, and the reference works out again
whatever the port derived from them.
"""
