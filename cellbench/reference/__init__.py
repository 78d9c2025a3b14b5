"""The plain reference: numpy and torch only, nothing of the program."""
