"""The plain reference: Algorithm 1 replayed event by event
(``replay.py``) over plain PyTorch models, one file per architecture
(``resnet.py``, ``transformer.py``, each ``loss(params, cfg, batch)`` for
one worker's batch).  Nothing here imports the port, JAX or the JAX
package; the reference works out the dynamics' constants, the replay and
the models again from the inputs the benchmark made.
"""
