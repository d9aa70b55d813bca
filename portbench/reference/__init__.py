"""The plain reference: a float32 forward of the Llama-family decoder in
plain PyTorch, independent of the program (it imports torch only)."""
