"""Recursive-descent parser for the DSL.

Reference: src/parser/Parser.cpp — statement dispatch :65-108, shunting-yard
expressions :160-309 (we use an equivalent Pratt/precedence-climbing parser),
chained-IndexAccess targets :311-334, negative-literal disambiguation
:210-220 / :336-386, rotate(expr, steps) as hard-coded Call :236-249, For with
multi-statement init/update :597-645, unsized-only array declarations
:729-740, bool-typed 0/1 literal coercion :345-360.

Grammar summary:
  program        := statement*
  statement      := function | for | if | return ';' | block
                  | variableDecl ';' | assignment ';'
  function       := 'public' datatype IDENT '(' params ')' block
  variableDecl   := ['secret'] type IDENT ['[' ']'] ['=' expression]
  assignment     := target '=' expression
  target         := IDENT ('[' expression ']')*
  expression     := Pratt parse over the reference's precedence table,
                    plus 'rotate' pseudo-call, {…} expression lists, ternary.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from abc_tpu_torch.ast_ir.nodes import (
    AbstractExpression, AbstractNode, AbstractStatement, AbstractTarget,
    Assignment, BinaryExpression, Block, Call, ExpressionList, For, Function,
    FunctionParameter, If, IndexAccess, Literal, LiteralBool, LiteralInt,
    Return, TernaryOperator, UnaryExpression, Variable, VariableDeclaration,
)
from abc_tpu_torch.parser.tokenizer import TokenStream
from abc_tpu_torch.parser.tokens import TYPE_KEYWORDS, TokKind, Token
from abc_tpu_torch.utils.datatype import Datatype, Type
from abc_tpu_torch.utils.errors import ParsingError
from abc_tpu_torch.utils.operators import Op, Operator

_BINARY_OPS = {
    "+": Op.ADD, "-": Op.SUB, "*": Op.MUL, "/": Op.DIV, "%": Op.MOD,
    "+++": Op.FHE_ADD, "---": Op.FHE_SUB, "***": Op.FHE_MUL,
    "&&": Op.LOGICAL_AND, "||": Op.LOGICAL_OR,
    "<": Op.LESS, "<=": Op.LESS_EQUAL, ">": Op.GREATER, ">=": Op.GREATER_EQUAL,
    "==": Op.EQUAL, "!=": Op.NOTEQUAL,
    "&": Op.BITWISE_AND, "^": Op.BITWISE_XOR, "|": Op.BITWISE_OR,
}
_UNARY_OPS = {"!": Op.LOGICAL_NOT, "~": Op.BITWISE_NOT}
_TERNARY_PRECEDENCE = 16  # looser than || (15); right-associative


class Parser:
    """parse(source) -> Block of top-level statements (ref: Parser.h:88-96)."""

    def __init__(self, source: str):
        self.ts = TokenStream(source)
        # bool-declaration context: 0/1 integer literals become LiteralBool
        # (ref: Parser.cpp:345-360 varAssignmentDatatype)
        self._decl_datatype: Optional[Datatype] = None
        self.parsed_nodes: List[AbstractNode] = []

    # --- public API ---------------------------------------------------------
    @staticmethod
    def parse(source: str) -> Block:
        """Parse a whole program; always returns a root Block."""
        p = Parser(source)
        stmts: List[AbstractStatement] = []
        while not p.ts.current.is_eof():
            stmts.append(p.parse_statement())
        root = Block(stmts)
        p._note(root)
        return root

    @staticmethod
    def parse_with_nodes(source: str) -> Tuple[Block, List[AbstractNode]]:
        """Overload returning every created node in parse order
        (ref: Parser.h:95-96; used by tests to address nodes by index)."""
        p = Parser(source)
        stmts: List[AbstractStatement] = []
        while not p.ts.current.is_eof():
            stmts.append(p.parse_statement())
        root = Block(stmts)
        p._note(root)
        return root, p.parsed_nodes

    def _note(self, node: AbstractNode) -> AbstractNode:
        self.parsed_nodes.append(node)
        return node

    # --- statements ---------------------------------------------------------
    def parse_statement(self, gobble_semicolon: bool = True) -> AbstractStatement:
        tok = self.ts.current
        if tok.is_reserved("for"):
            return self.parse_for()
        if tok.is_reserved("if"):
            return self.parse_if()
        if tok.is_reserved("return"):
            stmt = self.parse_return()
            if gobble_semicolon:
                self.ts.expect(";")
            return stmt
        if tok.is_reserved("{"):
            return self.parse_block()
        if tok.is_reserved("public"):
            return self.parse_function()
        if tok.is_reserved("secret") or (tok.kind == TokKind.RESERVED
                                         and tok.value in TYPE_KEYWORDS):
            stmt = self.parse_variable_declaration()
            if gobble_semicolon:
                self.ts.expect(";")
            return stmt
        # otherwise: must be an assignment
        stmt = self.parse_assignment()
        if gobble_semicolon:
            self.ts.expect(";")
        return stmt

    def parse_datatype(self) -> Datatype:
        secret = self.ts.accept("secret")
        tok = self.ts.current
        if not (tok.kind == TokKind.RESERVED and tok.value in TYPE_KEYWORDS):
            raise ParsingError(f"expected a type name but found {tok.value!r}",
                               tok.line, tok.char)
        self.ts.advance()
        return Datatype.from_string(tok.value, secret)

    def parse_variable_declaration(self) -> VariableDeclaration:
        datatype = self.parse_datatype()
        variable = self._note(Variable(self._expect_identifier()))
        # unsized array declaration `int i[];` (ref: Parser.cpp:729-740)
        if self.ts.accept("["):
            if not self.ts.accept("]"):
                tok = self.ts.current
                raise ParsingError(
                    "fixed-size array declarations are not supported; "
                    "declare arrays without a size, e.g. `int i[];`",
                    tok.line, tok.char)
        value = None
        if not self.ts.current.is_reserved(";"):
            self.ts.expect("=")
            self._decl_datatype = datatype
            try:
                value = self.parse_expression()
            finally:
                self._decl_datatype = None
        return self._note(VariableDeclaration(datatype, variable, value))

    def parse_assignment(self) -> Assignment:
        target = self.parse_target()
        self.ts.expect("=")
        value = self.parse_expression()
        return self._note(Assignment(target, value))

    def parse_return(self) -> Return:
        self.ts.expect("return")
        if self.ts.current.is_reserved(";"):
            return self._note(Return())
        return self._note(Return(self.parse_expression()))

    def parse_block(self) -> Block:
        self.ts.expect("{")
        stmts: List[AbstractStatement] = []
        while not self.ts.current.is_reserved("}"):
            if self.ts.current.is_eof():
                tok = self.ts.current
                raise ParsingError("unterminated block", tok.line, tok.char)
            stmts.append(self.parse_statement())
        self.ts.expect("}")
        return self._note(Block(stmts))

    def parse_block_or_single_statement(self) -> Block:
        if self.ts.current.is_reserved("{"):
            return self.parse_block()
        return self._note(Block([self.parse_statement()]))

    def parse_if(self) -> If:
        self.ts.expect("if")
        self.ts.expect("(")
        condition = self.parse_expression()
        self.ts.expect(")")
        then_branch = self.parse_block_or_single_statement()
        else_branch = None
        if self.ts.accept("else"):
            else_branch = self.parse_block_or_single_statement()
        return self._note(If(condition, then_branch, else_branch))

    def parse_for(self) -> For:
        # for (init-stmts; condition; update-stmts) block  (ref: Parser.cpp:597-645)
        self.ts.expect("for")
        self.ts.expect("(")
        init_stmts: List[AbstractStatement] = []
        if not self.ts.current.is_reserved(";"):
            init_stmts.append(self.parse_statement(gobble_semicolon=False))
            while self.ts.accept(","):
                init_stmts.append(self.parse_statement(gobble_semicolon=False))
        self.ts.expect(";")
        initializer = self._note(Block(init_stmts))
        condition = self.parse_expression()
        self.ts.expect(";")
        update_stmts: List[AbstractStatement] = []
        if not self.ts.current.is_reserved(")"):
            update_stmts.append(self.parse_statement(gobble_semicolon=False))
            while self.ts.accept(","):
                update_stmts.append(self.parse_statement(gobble_semicolon=False))
        self.ts.expect(")")
        update = self._note(Block(update_stmts))
        body = self.parse_block()
        return self._note(For(initializer, condition, update, body))

    def parse_function(self) -> Function:
        self.ts.expect("public")
        return_type = self.parse_datatype()
        name = self._expect_identifier()
        self.ts.expect("(")
        params: List[FunctionParameter] = []
        while not self.ts.current.is_reserved(")"):
            ptype = self.parse_datatype()
            pname = self._expect_identifier()
            params.append(self._note(FunctionParameter(ptype, pname)))
            if not self.ts.current.is_reserved(")"):
                self.ts.expect(",")
        self.ts.expect(")")
        body = self.parse_block()
        return self._note(Function(return_type, name, params, body))

    # --- expressions (Pratt) ------------------------------------------------
    def parse_expression(self) -> AbstractExpression:
        return self._parse_binary(_TERNARY_PRECEDENCE)

    def _parse_binary(self, max_precedence: int) -> AbstractExpression:
        lhs = self._parse_unary()
        while True:
            tok = self.ts.current
            # postfix ++/-- → x+1 / x-1 (ref: Parser.cpp:191-210)
            if tok.is_reserved("++") or tok.is_reserved("--"):
                self.ts.advance()
                op = Operator(Op.ADD if tok.value == "++" else Op.SUB)
                lhs = self._note(BinaryExpression(lhs, op, self._note(LiteralInt(1))))
                continue
            if tok.is_reserved("?") and max_precedence >= _TERNARY_PRECEDENCE:
                self.ts.advance()
                then_e = self.parse_expression()
                self.ts.expect(":")
                else_e = self._parse_binary(_TERNARY_PRECEDENCE)
                lhs = self._note(TernaryOperator(lhs, then_e, else_e))
                continue
            if tok.kind != TokKind.RESERVED or tok.value not in _BINARY_OPS:
                return lhs
            op = Operator(_BINARY_OPS[tok.value])
            prec = op.precedence()
            if prec >= max_precedence:
                return lhs
            self.ts.advance()
            # left-associative: sub-parse binds strictly tighter
            rhs = self._parse_binary(prec)
            lhs = self._note(BinaryExpression(lhs, op, rhs))

    def _parse_unary(self) -> AbstractExpression:
        tok = self.ts.current
        if tok.kind == TokKind.RESERVED and tok.value in _UNARY_OPS:
            self.ts.advance()
            operand = self._parse_unary()
            return self._note(UnaryExpression(operand, Operator(_UNARY_OPS[tok.value])))
        # negative literal: '-' in operand position followed by a number
        # (ref: Parser.cpp:210-220, 336-386)
        if tok.is_reserved("-") and self.ts.peek().kind in (TokKind.INT, TokKind.DOUBLE,
                                                            TokKind.FLOAT):
            self.ts.advance()
            return self._parse_literal(negative=True)
        return self._parse_primary()

    def _parse_primary(self) -> AbstractExpression:
        tok = self.ts.current
        if tok.kind in (TokKind.INT, TokKind.DOUBLE, TokKind.FLOAT, TokKind.STRING,
                        TokKind.CHAR) or tok.is_reserved("true") or tok.is_reserved("false"):
            return self._parse_literal()
        if tok.is_identifier():
            return self.parse_target()
        if tok.is_reserved("("):
            self.ts.advance()
            e = self.parse_expression()
            self.ts.expect(")")
            return e
        if tok.is_reserved("{"):
            return self._parse_expression_list()
        if tok.is_reserved("rotate"):
            # rotate(expr, steps) as a hard-coded Call (ref: Parser.cpp:236-249)
            self.ts.advance()
            self.ts.expect("(")
            ctxt = self.parse_expression()
            self.ts.expect(",")
            steps = self.parse_expression()
            self.ts.expect(")")
            return self._note(Call("rotate", [ctxt, steps]))
        raise ParsingError(f"unexpected token {tok.value!r} in expression",
                           tok.line, tok.char)

    def _parse_literal(self, negative: bool = False) -> Literal:
        tok = self.ts.advance()
        if tok.kind == TokKind.STRING:
            lit = Literal(tok.value, Type.STRING)
        elif tok.kind == TokKind.CHAR:
            lit = Literal(tok.value, Type.CHAR)
        elif tok.kind == TokKind.DOUBLE:
            lit = Literal(-tok.value if negative else tok.value, Type.DOUBLE)
        elif tok.kind == TokKind.FLOAT:
            lit = Literal(-tok.value if negative else tok.value, Type.FLOAT)
        elif tok.kind == TokKind.INT:
            # in a bool declaration, 0/1 become LiteralBool (ref: Parser.cpp:345-360)
            if (self._decl_datatype is not None
                    and self._decl_datatype.type == Type.BOOL):
                if tok.value not in (0, 1):
                    raise ParsingError(
                        "variable declaration declares bool but value is neither 0 nor 1",
                        tok.line, tok.char)
                if negative:
                    raise ParsingError("a minus sign in front of a bool is not allowed",
                                       tok.line, tok.char)
                lit = LiteralBool(bool(tok.value))
            else:
                lit = LiteralInt(-tok.value if negative else tok.value)
        elif tok.is_reserved("true"):
            lit = LiteralBool(True)
        elif tok.is_reserved("false"):
            lit = LiteralBool(False)
        else:
            raise ParsingError(f"expected a literal but found {tok.value!r}",
                               tok.line, tok.char)
        if negative and tok.kind in (TokKind.STRING, TokKind.CHAR):
            raise ParsingError("a minus sign in front of a string or char is not allowed",
                               tok.line, tok.char)
        return self._note(lit)

    def _parse_expression_list(self) -> ExpressionList:
        self.ts.expect("{")
        exprs = [self.parse_expression()]
        while self.ts.accept(","):
            exprs.append(self.parse_expression())
        self.ts.expect("}")
        return self._note(ExpressionList(exprs))

    def parse_target(self) -> AbstractTarget:
        # Variable with chained [i][j] indices (ref: Parser.cpp:311-334)
        var = self._note(Variable(self._expect_identifier()))
        target: AbstractTarget = var
        while self.ts.current.is_reserved("["):
            self.ts.advance()
            index = self.parse_expression()
            self.ts.expect("]")
            target = self._note(IndexAccess(target, index))
        return target

    def _expect_identifier(self) -> str:
        tok = self.ts.current
        if not tok.is_identifier():
            raise ParsingError(f"expected an identifier but found {tok.value!r}",
                               tok.line, tok.char)
        self.ts.advance()
        return tok.value


def parse(source: str) -> Block:
    return Parser.parse(source)


def parse_with_nodes(source: str) -> Tuple[Block, List[AbstractNode]]:
    return Parser.parse_with_nodes(source)
