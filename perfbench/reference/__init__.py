"""The plain reference: each query shape's answer in numpy, from the same
generated arrays the program ingests. Imports nothing of the program."""
