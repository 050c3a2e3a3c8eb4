"""Plain PyTorch / numpy references of what the program computes. They
import nothing of the program and take nothing it made: the benchmark
gives both sides the same inputs and weights, made from the seed."""
